"""The port's simulation generators (realpdebench_tpu_torch.sim: the 2-D
cylinder and FSI solver, the 3-D wing solver, the flow env) against the JAX
package's on the CPU, the JAX draws injected: fields at rtol 2e-4 and atol
2e-4·max|ref|, cd and cl absolute at 2e-4 of cd's scale. Then the JAX
package's mechanics tests (tests/test_sim.py) on the port."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realpdebench_tpu.sim import env as jenv
from realpdebench_tpu.sim import ns2d as J
from realpdebench_tpu.sim import ns3d as J3
from realpdebench_tpu_torch.sim import env as tenv
from realpdebench_tpu_torch.sim import ns2d as T
from realpdebench_tpu_torch.sim import ns3d as T3

RTOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the solver's tensors are small, so it runs as
    fast alone, and far faster beside other busy processes (the suite's
    other workers) than a pool of spinning threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# tests/test_sim.py's small mechanics config, and the default (shedding) geometry
CFG = dict(nx=64, ny=64, lx=4.0, ly=4.0, center=(1.0, 2.0), reynolds=150.0, dt=0.02,
           sponge_width=0.25)
DEFAULT = {}
CFG3 = dict(nx=32, ny=24, nz=12, dt=0.02)


def close(got, ref, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * np.abs(ref).max(),
                               err_msg=what)


def close_coef(got, ref, scale, what=""):
    """cd and cl, absolute against cd's scale (cl is ~1e-4 before shedding)."""
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0,
                               atol=RTOL * np.abs(np.asarray(scale)).max(), err_msg=what)


def jax_noise(shape, seed=0):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))


def configs(kw):
    return J.SolverConfig(**kw), T.SolverConfig(**kw)


@functools.lru_cache(maxsize=None)
def _jax_stepper(items):
    return jax.jit(J.make_stepper(J.SolverConfig(**dict(items))))


def jax_stepper(kw):
    """The JAX stepper of ``kw`` jitted once for the file."""
    return _jax_stepper(tuple(sorted(kw.items())))


@pytest.mark.parametrize("kw", [CFG, DEFAULT], ids=["cfg64", "default"])
def test_constants_match_jax(kw):
    jc, tc = configs(kw)
    close(T.cylinder_fraction(tc, device="cpu"), J.cylinder_fraction(jc), "body")
    close(T.cylinder_fraction(tc, center=(1.5, 1.9), diameter=0.4, device="cpu"),
          J.cylinder_fraction(jc, center=(1.5, 1.9), diameter=0.4), "body elsewhere")
    np.testing.assert_array_equal(T._sponge(tc, "cpu").numpy(), np.asarray(J._sponge(jc)))
    for t, j in zip(T._wavenumbers(tc, "cpu"), J._wavenumbers(jc)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert T.force_reference(tc) == J.force_reference(jc)


def test_semi_lagrangian_laplacian_divergence_match_jax():
    """The backtrace, with departure points below 0 and past the grid (the
    floor-mod wrap), the Laplacian and the divergence."""
    rng = np.random.default_rng(0)
    f, u, v = (rng.standard_normal((24, 16)).astype(np.float32) for _ in range(3))
    u, v = 40 * u, 40 * v          # up to several cells a step, both signs
    args = (0.05, 0.1, 0.2)
    t = lambda a: torch.from_numpy(a)
    close(T._semi_lagrangian(t(f), t(u), t(v), *args), J._semi_lagrangian(f, u, v, *args))
    close(T._laplacian(t(f), 0.1, 0.2), J._laplacian(f, 0.1, 0.2))
    close(T.divergence(t(u), t(v), 0.1, 0.2), J.divergence(u, v, 0.1, 0.2))


@pytest.mark.parametrize("kw,n_steps", [(CFG, 1), (CFG, 20), (DEFAULT, 1)],
                         ids=["cfg64-1", "cfg64-20", "default-1"])
def test_stepper_matches_jax(kw, n_steps):
    jc, tc = configs(kw)
    noise = jax_noise((jc.nx, jc.ny))
    jstep, tstep = jax_stepper(kw), T.make_stepper(tc, device="cpu")
    jbody, tbody = J.cylinder_fraction(jc), T.cylinder_fraction(tc, device="cpu")
    js = J.initial_state(jc, jax.random.PRNGKey(0))
    ts = T.initial_state(tc, noise=noise, device="cpu")
    np.testing.assert_array_equal(ts[1].numpy(), np.asarray(js[1]))
    cds, tcds, cls_, tcls = [], [], [], []
    for _ in range(n_steps):
        js, (jp, jcd, jcl) = jstep(js, jbody)
        ts, (tp, tcd, tcl) = tstep(ts, tbody)
        cds.append(jcd), tcds.append(tcd), cls_.append(jcl), tcls.append(tcl)
    for got, ref, what in zip((*ts, tp), (*js, jp), "uvp"):
        close(got, ref, what)
    close_coef(torch.stack(tcds), np.stack(cds), cds, "cd")
    close_coef(torch.stack(tcls), np.stack(cls_), cds, "cl")


def test_stepper_body_velocity_matches_jax():
    """A translating body (the env's and the controlled sweep's action) as
    a number and as a 0-d tensor."""
    jc, tc = configs(CFG)
    noise = jax_noise((jc.nx, jc.ny))
    jstep, tstep = jax_stepper(CFG), T.make_stepper(tc, device="cpu")
    jbody, tbody = J.cylinder_fraction(jc), T.cylinder_fraction(tc, device="cpu")
    js = J.initial_state(jc, jax.random.PRNGKey(0))
    ts = T.initial_state(tc, noise=noise, device="cpu")
    for vel in ((0.3, -0.2), (0.0, torch.tensor(0.7))):
        js, (jp, jcd, jcl) = jstep(js, jbody, (vel[0], jnp.float32(vel[1])))
        ts, (tp, tcd, tcl) = tstep(ts, tbody, vel)
    for got, ref, what in zip((*ts, tp), (*js, jp), "uvp"):
        close(got, ref, what)
    close_coef(torch.stack((tcd, tcl)), np.stack((jcd, jcl)), jcd)


def test_fsi_stepper_matches_jax():
    jc, tc = configs(dict(nx=32, ny=32, reynolds=150.0))
    fsi = dict(mass=1.0, stiffness=6.0, damping=0.05)
    jstep = jax.jit(J.make_fsi_stepper(jc, J.FSIConfig(**fsi)))
    tstep = T.make_fsi_stepper(tc, T.FSIConfig(**fsi), device="cpu")
    ju, jv = J.initial_state(jc, jax.random.PRNGKey(0))
    tu, tv = T.initial_state(tc, noise=jax_noise((32, 32)), device="cpu")
    js = (ju, jv, jnp.asarray(jc.center, jnp.float32), jnp.zeros(2, jnp.float32))
    ts = (tu, tv, torch.tensor(tc.center), torch.zeros(2))
    cds, tcds = [], []
    for _ in range(8):
        js, (jp, jcd, jcl, jxc) = jstep(js)
        ts, (tp, tcd, tcl, txc) = tstep(ts)
        cds.append(jcd), tcds.append(tcd)
    for got, ref, what in zip((*ts, tp), (*js, jp), ("u", "v", "xc", "vc", "p")):
        close(got, ref, what)
    close_coef(torch.stack(tcds), np.stack(cds), cds, "cd")
    close(txc, jxc, "xc aux")


def test_simulate_matches_jax():
    jc, tc = configs(CFG)
    kw = dict(center=(1.2, 2.1), diameter=0.6, body_vel=(0.1, 0.2))
    frames, cd, cl = J.simulate(jc, jax.random.PRNGKey(3), 5, 2, **kw)
    tf, tcd, tcl = T.simulate(tc, None, 5, 2, noise=jax_noise((64, 64), 3), device="cpu",
                              **kw)
    close(tf, frames)
    close_coef(tcd, cd, cd, "cd")
    close_coef(tcl, cl, cd, "cl")
    # a generator's draw: the same trajectory as its draw injected
    g = torch.Generator().manual_seed(5)
    again = T.simulate(tc, torch.Generator().manual_seed(5), 2, 1, device="cpu")[0]
    inj = T.simulate(tc, None, 2, 1, noise=torch.randn(64, 64, generator=g), device="cpu")[0]
    assert torch.equal(again, inj)


def test_simulate_fsi_matches_jax():
    jc, tc = configs(dict(nx=32, ny=32, reynolds=150.0))
    fsi = dict(mass=1.0, stiffness=6.0, damping=0.05)
    frames, cd, cl, centers = J.simulate_fsi(jc, J.FSIConfig(**fsi), jax.random.PRNGKey(0),
                                             6, substeps=2)
    tf, tcd, tcl, tce = T.simulate_fsi(tc, T.FSIConfig(**fsi), None, 6, substeps=2,
                                       noise=jax_noise((32, 32)), device="cpu")
    close(tf, frames)
    close(tce, centers)
    close_coef(tcd, cd, cd, "cd")
    close_coef(tcl, cl, cd, "cl")


def test_float64_copy_runs_the_same_function():
    """A float64 state runs the stepper in float64 from the promoted f32
    constants: within f32 rounding of the f32 step, and not equal to it."""
    tc = T.SolverConfig(**CFG)
    step = T.make_stepper(tc, device="cpu")
    body = T.cylinder_fraction(tc, device="cpu")
    s32 = T.initial_state(tc, noise=jax_noise((64, 64)), device="cpu")
    s64 = tuple(x.double() for x in s32)
    for _ in range(3):
        s32, (p32, _, _) = step(s32, body)
        s64, (p64, _, _) = step(s64, body)
    assert s64[0].dtype == p64.dtype == torch.float64
    close(s32[0], s64[0].numpy())
    close(p32, p64.numpy())
    assert not torch.equal(s32[0].double(), s64[0])


# --- 3-D wing -------------------------------------------------------------


def configs3(kw=CFG3):
    return J3.Solver3DConfig(**kw), T3.Solver3DConfig(**kw)


jax_wing = jax.jit(J3.wing_fraction, static_argnums=0)


def test_wing_fraction_matches_jax():
    jc, tc = configs3()
    close(T3.wing_fraction(tc, device="cpu"), jax_wing(jc))
    close(T3.wing_fraction(tc, torch.tensor(13.5), device="cpu"),
          jax_wing(jc, jnp.float32(13.5)))
    xc = np.linspace(-0.2, 1.2, 31, dtype=np.float32)
    close(T3.naca_half_thickness(torch.from_numpy(xc), 0.25),
          J3.naca_half_thickness(xc, 0.25))


def test_semi_lagrangian_3d_matches_jax():
    rng = np.random.default_rng(1)
    f, u, v, w = (rng.standard_normal((10, 8, 6)).astype(np.float32) for _ in range(4))
    sp = (0.1, 0.15, 0.2)
    t = lambda a: torch.from_numpy(a)
    close(T3._semi_lagrangian_3d(t(f), t(30 * u), t(30 * v), t(30 * w), 0.05, sp),
          J3._semi_lagrangian_3d(f, 30 * u, 30 * v, 30 * w, 0.05, sp))
    close(T3._laplacian_3d(t(f), sp), J3._laplacian_3d(f, sp))


@pytest.mark.parametrize("moving", [False, True], ids=["static", "moving"])
def test_stepper_3d_matches_jax(moving):
    jc, tc = configs3()
    noise = jax_noise((32, 24, 12))
    jstep, tstep = jax.jit(J3.make_stepper_3d(jc)), T3.make_stepper_3d(tc, device="cpu")
    jbody, tbody = jax_wing(jc), T3.wing_fraction(tc, device="cpu")
    u = np.full((32, 24, 12), 1.0, np.float32)
    js = (u, 1e-2 * noise, np.zeros_like(u))
    ts = T3._initial_state(tc, None, noise, "cpu")
    jvel = tvel = None
    if moving:
        X, Y, _ = (g.numpy() for g in T3._grids(tc))
        jvel = (-0.5 * (Y - 1.0), 0.5 * (X - 0.8), 0.0)
        tvel = (torch.from_numpy(jvel[0]), torch.from_numpy(jvel[1]), 0.0)
    for _ in range(3):
        js, jp = jstep(js, jbody, jvel)
        ts, tp = tstep(ts, tbody, tvel)
    for got, ref, what in zip((*ts, tp), (*js, jp), "uvwp"):
        close(got, ref, what)


@functools.lru_cache(maxsize=None)
def jax_foil_volume():
    """The JAX wing's full volume over 4 frames of 2 substeps, run once for
    the file: its mid-span (u, v, p) planes are the slice frames."""
    return np.asarray(J3.simulate_foil(configs3()[0], jax.random.PRNGKey(0), 4, 2, True))


@pytest.mark.parametrize("full_volume", [False, True], ids=["slice", "volume"])
def test_simulate_foil_matches_jax(full_volume):
    tc = configs3()[1]
    ref = jax_foil_volume()
    if not full_volume:
        ref = ref[:, :, :, tc.nz // 2][..., [0, 1, 3]]
    got = T3.simulate_foil(tc, None, 4, 2, full_volume, noise=jax_noise((32, 24, 12)),
                           device="cpu")
    close(got, ref)


def test_simulate_pitching_foil_matches_jax():
    jc, tc = configs3()
    ref, ref_aoa = J3.simulate_pitching_foil(jc, jax.random.PRNGKey(0), 4, 2,
                                             pitch_amp_deg=8.0, pitch_freq=2.0)
    got, aoa = T3.simulate_pitching_foil(tc, None, 4, 2, pitch_amp_deg=8.0,
                                         pitch_freq=2.0, noise=jax_noise((32, 24, 12)),
                                         device="cpu")
    close(got, ref)
    close(aoa, ref_aoa)


# --- env ------------------------------------------------------------------


def test_env_matches_jax():
    jc, tc = configs(CFG)
    je, te = jenv.FlowEnv(jc, substeps=2), tenv.FlowEnv(tc, substeps=2, device="cpu")
    np.testing.assert_array_equal(te.reset(noise=jax_noise((64, 64))), je.reset())
    for action in (0.0, 0.4, -0.3):
        jo, jr, jd, ji = je.step(action)
        to, tr, td, ti = te.step(action)
        close(to, jo, "obs")
        assert td == jd and set(ti) == set(ji)
        close(ti["pressure"], ji["pressure"], "pressure")
        close(ti["body_boundary"], ji["body_boundary"], "body")
        for k in ("cd", "cl"):
            assert abs(ti[k] - ji[k]) <= RTOL * abs(ji["cd"]), (k, ti[k], ji[k])
        assert abs(tr - jr) <= RTOL * abs(jr)


def test_inverse_ffts_go_through_spectral_irfftn(monkeypatch):
    """Every inverse FFT of the steppers is ops.spectral.irfftn (the
    pressure spectrum is not Hermitian: cuFFT's multi-axis inverse leaves it
    undefined); torch.fft's multi-axis real inverses are never called."""
    calls = []
    for mod in (T, T3):
        real = mod.irfftn
        monkeypatch.setattr(mod, "irfftn", lambda *a, real=real, **k: calls.append(
            a[0].shape) or real(*a, **k))

    def refuse(*a, **k):
        raise AssertionError("a multi-axis torch.fft inverse was called")

    for name in ("irfft2", "irfftn", "ifft2"):
        monkeypatch.setattr(torch.fft, name, refuse)
    cfg = T.SolverConfig(nx=16, ny=8)
    T.make_stepper(cfg, device="cpu")(T.initial_state(cfg, noise=np.zeros((16, 8)),
                                                      device="cpu"),
                                      T.cylinder_fraction(cfg, device="cpu"))
    cfg3 = T3.Solver3DConfig(nx=8, ny=8, nz=4)
    T3.make_stepper_3d(cfg3, device="cpu")(
        T3._initial_state(cfg3, None, np.zeros((8, 8, 4)), "cpu"),
        T3.wing_fraction(cfg3, device="cpu"))
    # two projections of the stacked (u, v, p) spectra, one of (u, v, w, p)
    assert calls == [(3, 16, 5), (3, 16, 5), (4, 8, 8, 3)], calls


@pytest.mark.parametrize("call", [
    lambda: T.make_stepper(T.SolverConfig(nx=8, ny=8)),
    lambda: T.initial_state(T.SolverConfig(nx=8, ny=8)),
    lambda: T.simulate(T.SolverConfig(nx=8, ny=8), None, 1),
    lambda: T.simulate_fsi(T.SolverConfig(nx=8, ny=8), T.FSIConfig(), None, 1),
    lambda: T3.make_stepper_3d(T3.Solver3DConfig(nx=8, ny=8, nz=4)),
    lambda: T3.simulate_foil(T3.Solver3DConfig(nx=8, ny=8, nz=4), None, 1,
                             noise=np.zeros((8, 8, 4))),
    lambda: tenv.FlowEnv(T.SolverConfig(nx=8, ny=8)),
], ids=["make_stepper", "initial_state", "simulate", "simulate_fsi", "make_stepper_3d",
        "simulate_foil", "FlowEnv"])
def test_default_device_is_the_card(call):
    """device=None means the CUDA device: it raises where there is none,
    never a silent CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    with pytest.raises(RuntimeError, match="CUDA device"):
        call()


@pytest.mark.parametrize("call", [
    lambda: T.initial_state(T.SolverConfig(nx=8, ny=8), device="cpu"),
    lambda: T.simulate(T.SolverConfig(nx=8, ny=8), None, 1, device="cpu"),
    lambda: T3.simulate_foil(T3.Solver3DConfig(nx=8, ny=8, nz=4), None, 1, device="cpu"),
], ids=["initial_state", "simulate", "simulate_foil"])
def test_initial_state_needs_a_draw(call):
    """Without a generator or a noise draw the initial state raises, as the
    JAX package's needs a key: never an unperturbed stream that never sheds."""
    with pytest.raises(ValueError, match="generator or a noise draw"):
        call()


# --- the JAX package's mechanics tests, on the port --------------------------

TCFG = T.SolverConfig(**CFG)


def _spectral_divergence(u, v, cfg):
    kx = 2 * np.pi * np.fft.fftfreq(cfg.nx, d=cfg.dx)[:, None]
    ky = 2 * np.pi * np.fft.rfftfreq(cfg.ny, d=cfg.dy)[None, :]
    div_hat = 1j * (kx * np.fft.rfft2(u) + ky * np.fft.rfft2(v))
    return np.fft.irfft2(div_hat, s=(cfg.nx, cfg.ny))


def test_projection_divergence_free():
    step = T.make_stepper(TCFG, device="cpu")
    body = T.cylinder_fraction(TCFG, device="cpu")
    state = T.initial_state(TCFG, torch.Generator().manual_seed(0), device="cpu")
    for _ in range(5):
        state, (p, cd, cl) = step(state, body)
    u, v = (s.numpy().astype(np.float64) for s in state)
    div = _spectral_divergence(u, v, TCFG)
    assert np.abs(div).max() < 1e-3, np.abs(div).max()
    assert np.isfinite(u).all()


def test_body_enforces_no_slip():
    step = T.make_stepper(TCFG, device="cpu")
    body = T.cylinder_fraction(TCFG, device="cpu")
    state = T.initial_state(TCFG, torch.Generator().manual_seed(0), device="cpu")
    for _ in range(20):
        state, _ = step(state, body)
    interior = body.numpy() > 0.95
    assert np.abs(state[0].numpy()[interior]).mean() < 0.25 * TCFG.u_inf


def test_wake_develops():
    frames, cd, cl = T.simulate(TCFG, torch.Generator().manual_seed(1), n_frames=120,
                                substeps=2, device="cpu")
    frames = frames.numpy()
    assert frames.shape == (120, 64, 64, 3)
    assert np.isfinite(frames).all()
    # mean drag positive; late-time transverse velocity fluctuates in the wake
    assert float(cd[-40:].mean()) > 0
    assert frames[-40:, 40:, 28:36, 1].std() > 1e-3


def test_env_api():
    env = tenv.FlowEnv(TCFG, substeps=2, device="cpu")
    obs = env.reset()
    assert obs.shape == (64 * 64 * 2,)
    obs, reward, done, info = env.step(0.0)
    assert obs.shape == (64 * 64 * 2,)
    assert np.isfinite(info["cd"]) and np.isfinite(info["cl"])
    assert info["body_boundary"].shape == (64, 64)
    assert info["pressure"].shape == (64, 64)


def test_foil_3d():
    cfg = T3.Solver3DConfig(**CFG3)
    body = T3.wing_fraction(cfg, device="cpu").numpy()
    assert body.shape == (32, 24, 12)
    assert 0 < body.max() <= 1.0 and body.min() >= 0.0
    assert body.sum() > 5  # the wing occupies some volume
    gen = lambda: torch.Generator().manual_seed(0)
    frames = T3.simulate_foil(cfg, gen(), n_frames=8, substeps=1, device="cpu").numpy()
    assert frames.shape == (8, 32, 24, 3)
    assert np.isfinite(frames).all()
    # full-volume mode: the mid-span u/v/p planes coincide with the slices
    vol = T3.simulate_foil(cfg, gen(), n_frames=8, substeps=1, full_volume=True,
                           device="cpu").numpy()
    assert vol.shape == (8, 32, 24, 12, 4)
    assert np.isfinite(vol).all()
    mid = cfg.nz // 2
    for c, ch in ((0, 0), (1, 1), (3, 2)):
        np.testing.assert_array_equal(vol[:, :, :, mid, c], frames[..., ch])


def test_pitching_foil_3d():
    """Zero pitch amplitude reproduces the static solver; a nonzero one
    changes the flow and stays finite, and the AoA trace moves."""
    cfg = T3.Solver3DConfig(**CFG3)
    gen = lambda: torch.Generator().manual_seed(0)
    static = T3.simulate_foil(cfg, gen(), n_frames=6, substeps=1, device="cpu").numpy()
    frames0, aoa0 = T3.simulate_pitching_foil(cfg, gen(), n_frames=6, substeps=1,
                                              pitch_amp_deg=0.0, device="cpu")
    np.testing.assert_allclose(frames0.numpy(), static, atol=1e-5)
    np.testing.assert_allclose(aoa0.numpy(), cfg.aoa_deg, atol=1e-6)
    frames, aoas = T3.simulate_pitching_foil(cfg, gen(), n_frames=6, substeps=1,
                                             pitch_amp_deg=8.0, pitch_freq=2.0,
                                             device="cpu")
    frames = frames.numpy()
    assert frames.shape == (6, 32, 24, 3)
    assert np.isfinite(frames).all()
    assert np.abs(frames - static).max() > 1e-3
    assert aoas.numpy().std() > 0.5


def test_fsi_body_responds_to_flow():
    """The elastically mounted cylinder moves (VIV): the excursion is
    nonzero, bounded by the clamp, and the fields finite."""
    cfg = T.SolverConfig(nx=32, ny=32, reynolds=150.0)
    fsi = T.FSIConfig(mass=1.0, stiffness=6.0, damping=0.05)
    frames, cd, cl, centers = T.simulate_fsi(cfg, fsi, torch.Generator().manual_seed(0),
                                             48, substeps=2, device="cpu")
    frames, centers = frames.numpy(), centers.numpy()
    assert frames.shape == (48, 32, 32, 3)
    assert np.isfinite(frames).all() and np.isfinite(centers).all()
    assert np.abs(centers - centers[0]).max() > 1e-4, "body never moved"
    max_off = fsi.max_excursion * cfg.diameter + 1e-6
    assert np.abs(centers - np.asarray(cfg.center)).max() <= max_off
