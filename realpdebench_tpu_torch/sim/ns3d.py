"""3-D incompressible Navier–Stokes with an immersed tapered-NACA wing, in
PyTorch.

Counterpart of ``realpdebench_tpu/sim/ns3d.py`` (the reference generator is
WaterLily.jl's tapered NACA0025 wing at an angle of attack). The same
fractional-step scheme as ``ns2d``, lifted to 3-D: semi-Lagrangian
advection (trilinear backtrace), explicit diffusion, tanh-smoothed SDF body
blending, fully spectral Helmholtz projection on the periodic box, and an
inflow sponge. A trajectory is a loop of substeps on the device; frames are
saved as the mid-span slice (the 2-D fields the benchmark's foil HDF5 files
carry) or as the whole volume. The components are advected and projected
stacked; every inverse FFT goes through ``ops.spectral.irfftn``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from realpdebench_tpu_torch.models.registry import resolve_device
from realpdebench_tpu_torch.ops.spectral import irfftn
from realpdebench_tpu_torch.sim.ns2d import (
    _blend,
    _Constants,
    _draw_tensor,
    _inverse_k2,
    fftfreq,
    rfftfreq,
)


@dataclasses.dataclass(frozen=True)
class Solver3DConfig:
    nx: int = 96
    ny: int = 64
    nz: int = 32
    lx: float = 3.0
    ly: float = 2.0
    lz: float = 1.0
    u_inf: float = 1.0
    reynolds: float = 200.0
    chord: float = 0.6          # root chord length
    thickness: float = 0.25     # NACA00xx thickness ratio (0025)
    taper: float = 0.5          # tip chord = (1 - taper) · root chord
    aoa_deg: float = 10.0       # angle of attack
    center: Tuple[float, float, float] = (0.8, 1.0, 0.5)
    dt: float = 0.008
    smoothing: float = 1.5
    sponge_width: float = 0.2

    @property
    def spacing(self):
        return self.lx / self.nx, self.ly / self.ny, self.lz / self.nz

    @property
    def viscosity(self):
        return self.u_inf * self.chord / self.reynolds


def _grids(cfg, device=None):
    dx, dy, dz = cfg.spacing
    x = (torch.arange(cfg.nx, dtype=torch.float32, device=device) + 0.5) * dx
    y = (torch.arange(cfg.ny, dtype=torch.float32, device=device) + 0.5) * dy
    z = (torch.arange(cfg.nz, dtype=torch.float32, device=device) + 0.5) * dz
    return torch.meshgrid(x, y, z, indexing="ij")


def naca_half_thickness(xc, t):
    """NACA 00xx half-thickness profile on chord coordinate xc ∈ [0, 1]."""
    xc = torch.clamp(xc, 0.0, 1.0)
    return 5 * t * (
        0.2969 * torch.sqrt(xc) - 0.1260 * xc - 0.3516 * xc**2
        + 0.2843 * xc**3 - 0.1036 * xc**4
    )


def _angle(aoa_deg, device):
    """The angle of attack in radians as float32 (jnp.deg2rad's rounding)."""
    a = torch.as_tensor(aoa_deg, dtype=torch.float32, device=device)
    return torch.deg2rad(a)


class _Wing:
    """The wing's geometry on the grid, without the angle: the
    float32 fields the body fraction needs at any angle of attack."""

    def __init__(self, cfg: Solver3DConfig, device):
        X, Y, Z = _grids(cfg, device)
        cx, cy, cz = cfg.center
        self.cfg = cfg
        self.x, self.y = X - cx, Y - cy
        zl = Z - cz
        half_span = cfg.lz * 0.35
        span_frac = torch.clamp(torch.abs(zl) / half_span, 0.0, 1.0)
        self.chord = cfg.chord * (1.0 - cfg.taper * span_frac)
        self.d_span = torch.abs(zl) - half_span

    def fraction(self, a):
        """Smoothed body fraction at the angle ``a`` (radians, a float32
        0-d tensor): the wing rotated about the spanwise z axis."""
        cfg, chord = self.cfg, self.chord
        ca, sa = torch.cos(a), torch.sin(a)
        xl = self.x * ca + self.y * sa
        yl = -self.x * sa + self.y * ca
        xc = xl / torch.clamp_min(chord, 1e-6)
        yt = naca_half_thickness(xc, cfg.thickness) * chord
        # approximate signed distance: outside in chordwise/spanwise bounds or
        # beyond the thickness envelope
        d_thick = torch.abs(yl) - yt
        d_chord = torch.maximum(-xl, xl - chord)
        sdf = torch.maximum(torch.maximum(d_thick, d_chord), self.d_span)
        eps = cfg.smoothing * cfg.spacing[0]
        return 0.5 * (1.0 - torch.tanh(sdf / eps))


def wing_fraction(cfg: Solver3DConfig, aoa_deg=None, *, device=None):
    """Smoothed body fraction of the tapered NACA wing at angle of attack,
    float32 [nx, ny, nz].

    ``aoa_deg`` may be a 0-d tensor (time-varying pitch); defaults to the
    static ``cfg.aoa_deg``."""
    dev = resolve_device(device, "wing_fraction builds")
    return _Wing(cfg, dev).fraction(_angle(cfg.aoa_deg if aoa_deg is None else aoa_deg, dev))


def _sponge(cfg, device=None):
    X, _, _ = _grids(cfg, device)
    w = cfg.sponge_width * cfg.lx
    left = torch.clamp(1.0 - X / w, 0.0, 1.0)
    right = torch.clamp(1.0 - (cfg.lx - X) / w, 0.0, 1.0)
    return torch.maximum(left, right) ** 2


def _backtrace_3d(u, v, w, dt, spacing):
    """Departure points of the trilinear backtrace: the flat indices of the
    eight corners [2 (i), 2 (j), 2 (k), nx, ny, nz] and the weights, each
    (1 − f, f) along its own axis of the corners."""
    dx, dy, dz = spacing
    nx, ny, nz = u.shape
    ar = lambda n: torch.arange(n, device=u.device)
    xi = ar(nx)[:, None, None] - u * dt / dx
    yj = ar(ny)[None, :, None] - v * dt / dy
    zk = ar(nz)[None, None, :] - w * dt / dz
    i0, j0, k0 = torch.floor(xi), torch.floor(yj), torch.floor(zk)
    fx, fy, fz = xi - i0, yj - j0, zk - k0
    i0, j0, k0 = i0.long(), j0.long(), k0.long()
    ii = torch.remainder(torch.stack((i0, i0 + 1)), nx) * (ny * nz)
    jj = torch.remainder(torch.stack((j0, j0 + 1)), ny) * nz
    kk = torch.remainder(torch.stack((k0, k0 + 1)), nz)
    idx = ii[:, None, None] + jj[None, :, None] + kk[None, None, :]
    return (idx, torch.stack((1 - fx, fx))[:, None, None],
            torch.stack((1 - fy, fy))[None, :, None], torch.stack((1 - fz, fz))[None, None, :])


def _interp_3d(f, trace):
    """Trilinear interpolation of ``f`` ([..., nx, ny, nz]) at a backtrace's
    departure points, in JAX's order of terms (di, dj, dk loops), each
    g·wx·wy·wz."""
    idx, wx, wy, wz = trace
    t = f.flatten(-3)[..., idx] * wx * wy * wz
    out = t[..., 0, 0, 0, :, :, :]
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                if di or dj or dk:
                    out = out + t[..., di, dj, dk, :, :, :]
    return out


def _semi_lagrangian_3d(f, u, v, w, dt, spacing):
    return _interp_3d(f, _backtrace_3d(u, v, w, dt, spacing))


def _laplacian_3d(f, spacing):
    dx, dy, dz = spacing
    return (
        (torch.roll(f, -1, -3) - 2 * f + torch.roll(f, 1, -3)) / dx**2
        + (torch.roll(f, -1, -2) - 2 * f + torch.roll(f, 1, -2)) / dy**2
        + (torch.roll(f, -1, -1) - 2 * f + torch.roll(f, 1, -1)) / dz**2
    )


def make_stepper_3d(cfg: Solver3DConfig, *, device=None):
    """Build step(state, body, body_vel=None) → (state, p) on ``device``
    (None: the CUDA device, and an error where there is none); state =
    (u, v, w) each [nx, ny, nz], body_vel = (ub, vb, wb) numbers or fields
    (None: the static wing's zero velocity)."""
    dev = resolve_device(device, "make_stepper_3d builds")
    dx, dy, dz = cfg.spacing
    kx = 2 * math.pi * fftfreq(cfg.nx, dx, dev)[:, None, None]
    ky = 2 * math.pi * fftfreq(cfg.ny, dy, dev)[None, :, None]
    kz = 2 * math.pi * rfftfreq(cfg.nz, dz, dev)[None, None, :]
    sponge = _sponge(cfg, dev)
    consts = _Constants(kx=kx, ky=ky, kz=kz, inv_k2=_inverse_k2(kx**2 + ky**2 + kz**2),
                        keep_sponge=1 - sponge, inflow=sponge * cfg.u_inf)
    dt, nu = cfg.dt, cfg.viscosity
    spacing = cfg.spacing
    shape = (cfg.nx, cfg.ny, cfg.nz)

    def project(f, c):
        kx, ky, kz, inv_k2 = c["kx"], c["ky"], c["kz"], c["inv_k2"]
        uh, vh, wh = torch.fft.rfftn(f, dim=(-3, -2, -1))
        s = kx * uh + ky * vh + kz * wh
        uh = uh - kx * s * inv_k2
        vh = vh - ky * s * inv_k2
        wh = wh - kz * s * inv_k2
        out = irfftn(torch.stack((uh, vh, wh, -1j * s * inv_k2 / dt)), s=shape,
                     dim=(-3, -2, -1))
        return out[:3], out[3]

    def step(state, body, body_vel=None):
        u, v, w = state
        c = consts(u.dtype)
        body = body.to(u.dtype)
        a = _semi_lagrangian_3d(torch.stack((u, v, w)), u, v, w, dt, spacing)
        d = a + dt * nu * _laplacian_3d(a, spacing)
        # BDIM blend: inside the body the flow takes the body's local
        # velocity (zero for the static wing)
        f = _blend(1 - body, body, d, (0.0, 0.0, 0.0) if body_vel is None else body_vel)
        f = c["keep_sponge"] * f
        f[0] += c["inflow"]
        uvw, p = project(f, c)
        return (uvw[0], uvw[1], uvw[2]), p

    return step


def _initial_state(cfg, key, noise, device):
    shape = (cfg.nx, cfg.ny, cfg.nz)
    u = torch.full(shape, cfg.u_inf, dtype=torch.float32, device=device)
    if noise is None:
        if key is None:
            raise ValueError("the wing's initial state needs a generator or a noise draw")
        noise = torch.randn(shape, generator=key, device=key.device)
    v = torch.zeros_like(u) + 1e-2 * _draw_tensor(noise).to(device)
    return u, v, torch.zeros_like(u)


def _frame(state, p, full_volume: bool, mid: int):
    u, v, w = state
    if full_volume:
        return (u, v, w, p)
    return (u[:, :, mid], v[:, :, mid], p[:, :, mid])


def _frames(cfg, n_frames, full_volume, device):
    shape = (n_frames, cfg.nx, cfg.ny) + ((cfg.nz, 4) if full_volume else (3,))
    return torch.empty(shape, dtype=torch.float32, device=device)


def simulate_foil(cfg: Solver3DConfig, key, n_frames: int, substeps: int = 4,
                  full_volume: bool = False, *, noise=None, device=None):
    """Roll a 3-D wing trajectory on the device; v starts as 1e-2 times a
    standard normal draw (``noise`` [nx, ny, nz], or a float32 draw from
    the generator ``key``).

    Returns mid-span-slice frames [n_frames, nx, ny, 3] with channels
    (u, v, p), the 2-D fields the benchmark's foil dataset files store, or,
    with ``full_volume=True``, the complete volumetric fields
    [n_frames, nx, ny, nz, 4] with channels (u, v, w, p)."""
    dev = resolve_device(device, "simulate_foil runs")
    step = make_stepper_3d(cfg, device=dev)
    body = wing_fraction(cfg, device=dev)
    state = _initial_state(cfg, key, noise, dev)
    frames = _frames(cfg, n_frames, full_volume, dev)
    for i in range(n_frames):
        for _ in range(substeps):
            state, p = step(state, body)
        for ch, x in enumerate(_frame(state, p, full_volume, cfg.nz // 2)):
            frames[i, ..., ch] = x
    return frames


def make_pitching_stepper(cfg: Solver3DConfig, pitch_amp_deg: float = 5.0,
                          pitch_freq: float = 0.5, *, device=None):
    """Build step(state, t) → (state, (p, aoa)) for the wing pitching as
    AoA(t) = aoa + amp·sin(2πft) about the spanwise axis through
    ``cfg.center`` (t a float32 0-d tensor on the device): the smoothed body
    fraction re-evaluated at the instantaneous angle (an analytic tanh
    field, no remeshing), and the BDIM blend driving the interior flow to
    the body's rigid-rotation velocity (−ω·(y−cy), ω·(x−cx), 0)."""
    dev = resolve_device(device, "make_pitching_stepper builds")
    step = make_stepper_3d(cfg, device=dev)
    wing = _Wing(cfg, dev)
    two_pi_f = 2.0 * math.pi * pitch_freq
    amp_rad = _angle(pitch_amp_deg, dev)

    def pitching(state, t):
        aoa = cfg.aoa_deg + pitch_amp_deg * torch.sin(two_pi_f * t)
        omega = amp_rad * two_pi_f * torch.cos(two_pi_f * t)  # dθ/dt
        body = wing.fraction(torch.deg2rad(aoa))
        state, p = step(state, body, body_vel=(-omega * wing.y, omega * wing.x, 0.0))
        return state, (p, aoa)

    return pitching


def simulate_pitching_foil(cfg: Solver3DConfig, key, n_frames: int,
                           substeps: int = 4, pitch_amp_deg: float = 5.0,
                           pitch_freq: float = 0.5, full_volume: bool = False, *,
                           noise=None, device=None):
    """Pitching-wing trajectory (:func:`make_pitching_stepper`), t =
    substep · dt in float32. Same return layout as :func:`simulate_foil`,
    plus the per-frame AoA trace ``[n_frames]`` (the last substep's) as a
    second output."""
    dev = resolve_device(device, "simulate_pitching_foil runs")
    step = make_pitching_stepper(cfg, pitch_amp_deg, pitch_freq, device=dev)
    state = _initial_state(cfg, key, noise, dev)
    ts = (torch.arange(n_frames * substeps, dtype=torch.float32, device=dev)
          * cfg.dt).reshape(n_frames, substeps)
    frames = _frames(cfg, n_frames, full_volume, dev)
    aoa_trace = torch.empty(n_frames, dtype=torch.float32, device=dev)
    for i in range(n_frames):
        for j in range(substeps):
            state, (p, aoa) = step(state, ts[i, j])
        for ch, x in enumerate(_frame(state, p, full_volume, cfg.nz // 2)):
            frames[i, ..., ch] = x
        aoa_trace[i] = aoa
    return frames, aoa_trace
