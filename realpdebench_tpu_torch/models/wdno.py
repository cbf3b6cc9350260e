"""WDNO — the Wavelet-Domain Diffusion Neural Operator, over the port's Unet3d.

Counterpart of ``realpdebench_tpu/models/wdno.py`` (reference
`realpdebench/model/wdno.py:146-528`): the input and target windows are
packed channelwise, level-1 3-D DWT'd (``ops/wavelet``: 8 subbands per
channel, channel-major), padded to the U-Net's downsampling factor and
divided by a dataset-wide per-(channel × subband) rescaler
(``compute_wdno_rescaler``, cached). A DDPM learns to predict the noise on
the whole coefficient stack while the input channels and the padding are
clamped as conditions at every step (``set_conditions``). Sampling is DDIM
(whenever ``sampling_timesteps < timesteps``; the shipped configs: 10–25
steps) or ancestral.

Kept as the JAX package has them (ROADMAP.md's drift list):
  * the denoiser never sees the diffusion timestep: the reference feeds its
    backbone's time embedding zeros (its wdno.py:520), so the child
    ``Unet3d`` is called on the state alone;
  * the H-axis pad is reused for the W axis (exact for square coefficient
    grids, reproduced as it is otherwise);
  * the DDIM scalars are computed on the host from the float32 schedule
    entries, as the JAX loop takes them (numpy float32 arithmetic, then
    ``math.sqrt``);
  * the rescaler's cache file is the JAX package's own, so a cache written
    by either package is read by the other.

Draws: the loss draws ``t`` and the noise, sampling its initial state and
every step's noise, all from the model's own generator
(``Model.dropout_generator``, seeded by the config's ``seed``; the global
RNG is never used). ``loss`` and ``sample`` also take the draws from the
caller, which is how the tests feed both frameworks the same numbers.

Precision: the pipeline computes in the dtype of its schedule buffers
(float32; float64 for a ``.double()`` reference copy built with
``compute_dtype=torch.float64``); the denoiser in its ``compute_dtype``.
On a CUDA tensor the denoiser's temporal attention runs the TA kernels;
``reference=True`` runs their plain twin. A sample runs without autograd
(``predict``, under ``inference_mode``), so no graph spans its forwards.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch

from realpdebench_tpu_torch.models.base import Model, mse
from realpdebench_tpu_torch.models.unet import Unet3d
from realpdebench_tpu_torch.ops.wavelet import coef_len, wavedec3_level1, waverec3_level1


def linear_beta_schedule(timesteps):
    scale = 1000 / timesteps
    return np.linspace(scale * 0.0001, scale * 0.02, timesteps, dtype=np.float64)


def cosine_beta_schedule(timesteps, s=0.008):
    t = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64) / timesteps
    ac = np.cos((t + s) / (1 + s) * math.pi * 0.5) ** 2
    ac = ac / ac[0]
    betas = 1 - (ac[1:] / ac[:-1])
    return np.clip(betas, 0, 0.999)


def sigmoid_beta_schedule(timesteps, start=-3, end=3, tau=1):
    t = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64) / timesteps
    # the reference computes the endpoint sigmoids in float32 (its wdno.py:67-68)
    v_start = np.float64(1 / (1 + np.exp(np.float32(-start / tau))))
    v_end = np.float64(1 / (1 + np.exp(np.float32(-end / tau))))
    z = (t * (end - start) + start) / tau
    ac = (-1 / (1 + np.exp(-z)) + v_end) / (v_end - v_start)
    ac = ac / ac[0]
    betas = 1 - (ac[1:] / ac[:-1])
    return np.clip(betas, 0, 0.999)


BETA_SCHEDULES = {
    "linear": linear_beta_schedule,
    "cosine": cosine_beta_schedule,
    "sigmoid": sigmoid_beta_schedule,
}


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """The DDPM schedule, computed in float64 and stored as float32."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray

    @classmethod
    def create(cls, name: str, timesteps: int):
        betas = BETA_SCHEDULES[name](timesteps)
        alphas = 1.0 - betas
        ac = np.cumprod(alphas)
        ac_prev = np.concatenate([[1.0], ac[:-1]])
        post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
        with np.errstate(divide="ignore"):    # the linear schedule's last ᾱ is 0
            recip, recipm1 = np.sqrt(1 / ac), np.sqrt(1 / ac - 1)
        return cls(
            betas=betas.astype(np.float32),
            alphas_cumprod=ac.astype(np.float32),
            alphas_cumprod_prev=ac_prev.astype(np.float32),
            sqrt_alphas_cumprod=np.sqrt(ac).astype(np.float32),
            sqrt_one_minus_alphas_cumprod=np.sqrt(1 - ac).astype(np.float32),
            sqrt_recip_alphas_cumprod=recip.astype(np.float32),
            sqrt_recipm1_alphas_cumprod=recipm1.astype(np.float32),
            posterior_variance=post_var.astype(np.float32),
            posterior_log_variance_clipped=np.log(
                np.clip(post_var, 1e-20, None)).astype(np.float32),
            posterior_mean_coef1=(betas * np.sqrt(ac_prev) / (1 - ac)).astype(np.float32),
            posterior_mean_coef2=(
                (1 - ac_prev) * np.sqrt(alphas) / (1 - ac)).astype(np.float32),
        )

    def buffers(self) -> dict:
        """The state dict's schedule entries, as the JAX exporter writes them
        (``interop/torch_export.py::export_wdno``)."""
        out = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        out["log_one_minus_alphas_cumprod"] = np.log(
            1.0 - np.asarray(self.alphas_cumprod, np.float64)).astype(np.float32)
        return out


def rescaler_cache(dataset_root: str, dataset_name: str, wave_type: str,
                   pad_mode: str) -> str:
    """The rescaler's cache file, the JAX package's path."""
    return os.path.join(dataset_root, dataset_name,
                        f"wdno_rescaler_{wave_type}_{pad_mode}.npz")


def compute_wdno_rescaler(train_dataset, wave_type: str, pad_mode: str,
                          dataset_root: str, dataset_name: str, batch_size: int = 64,
                          device=None) -> np.ndarray:
    """Per-(channel × subband) abs-max over the numerical train set, zeros
    set to 1, cached unscaled (key ``rescaler``) and returned ×1.4 as
    float32 [C·8] (reference find_rescaler, its wdno.py:76-111). The
    transform runs on ``device`` (the CPU when None)."""
    cache = rescaler_cache(dataset_root, dataset_name, wave_type, pad_mode)
    if os.path.exists(cache):
        with np.load(cache) as f:
            rescaler = f["rescaler"]
    else:
        if train_dataset.dataset_type != "numerical":
            raise ValueError("the WDNO rescaler is computed on numerical data, not "
                             f"{train_dataset.dataset_type!r}")
        rescaler = None
        n = len(train_dataset)
        with torch.inference_mode():
            for s in range(0, n, batch_size):
                items = [train_dataset[i] for i in range(s, min(s + batch_size, n))]
                data = pack_input_target(np.stack([it[0] for it in items]),
                                         np.stack([it[1] for it in items]))
                b, f, h, w, c = data.shape
                flat = torch.from_numpy(np.ascontiguousarray(
                    np.moveaxis(data, -1, 1).reshape(b * c, f, h, w))).to(device or "cpu")
                coefs = wavedec3_level1(flat.float(), wave_type).reshape(b, c * 8, -1)
                m = coefs.abs().amax(dim=(0, 2)).cpu().numpy()
                rescaler = m if rescaler is None else np.maximum(rescaler, m)
        rescaler[rescaler == 0] = 1
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        np.savez(cache, rescaler=rescaler)
    return (rescaler * 1.4).astype(np.float32)


def pack_input_target(x, y):
    """Pack the input window and the sub-frame-folded target (reference
    wdno.py:488-496): target (b, sub_f·f, h, w, c_t) → (b, f, h, w,
    c_t·sub_f) appended to x. numpy arrays or tensors."""
    b, f, h, w, _ = x.shape
    c_t = y.shape[-1]
    sub_f = y.shape[1] // f
    y_ = y.reshape(b, sub_f, f, h, w, c_t)
    if isinstance(x, torch.Tensor):
        y_ = y_.movedim(1, -1).reshape(b, f, h, w, c_t * sub_f)
        return torch.cat([x, y_.to(x.dtype)], dim=-1)
    y_ = np.moveaxis(y_, 1, -1).reshape(b, f, h, w, c_t * sub_f)
    return np.concatenate([x, y_], axis=-1)


class WDNO(Model):
    """The diffusion wrapper: geometry, schedule, conditioning, loss and
    sampling around the child ``model`` (a ``Unet3d`` on the padded
    coefficient grid, ``channels = out_channels = 8·(c_in + c_out)``, ``in_time
    = out_time`` the padded coefficient T).

    ``forward(x)`` samples the output window; ``forward(x, y)`` is the DDPM
    training loss. ``generator`` draws the child's initial weights;
    ``seed`` seeds the diffusion draws. ``rescaler`` [C·8] defaults to ones.
    """

    def __init__(self, shape_in: Sequence[int], shape_out: Sequence[int], dim: int,
                 dim_mults: Sequence[int] = (1, 2), wave_type: str = "bior1.3",
                 beta_schedule: str = "sigmoid", timesteps: int = 1000,
                 sampling_timesteps: Optional[int] = None, ddim_eta: float = 0.0,
                 rescaler: Optional[np.ndarray] = None,
                 compute_dtype: torch.dtype = torch.float32, remat: bool = True,
                 seed: int = 0, device=None, generator: torch.Generator | None = None):
        super().__init__()
        f, h, w, c_in = shape_in
        self.shape_in, self.shape_out = tuple(shape_in), tuple(shape_out)
        self.wave_type = wave_type
        self.c_in = c_in
        self.c_out = shape_out[-1] * shape_out[0] // f
        self.channels = 8 * (c_in + self.c_out)
        self.coef_shape = tuple(coef_len(n, wave_type) for n in (f, h, w))
        pf = self.pad_factor = 2 ** len(dim_mults)
        padded = tuple(((d + pf - 1) // pf) * pf for d in self.coef_shape)
        # the reference reuses the H pad for W (its wdno.py:190,341)
        self.pad_t = padded[0] - self.coef_shape[0]
        self.pad_x = padded[1] - self.coef_shape[1]
        self.model_shape = (padded[0], self.coef_shape[1] + self.pad_x,
                            self.coef_shape[2] + self.pad_x)
        self.schedule = DiffusionSchedule.create(beta_schedule, int(timesteps))
        self.num_timesteps = len(self.schedule.betas)
        self.sampling_timesteps = int(sampling_timesteps or self.num_timesteps)
        self.is_ddim = self.sampling_timesteps < self.num_timesteps
        self.ddim_eta = float(ddim_eta or 0.0)
        self.dropout_seed = int(seed)

        for k, v in self.schedule.buffers().items():
            self.register_buffer(k, torch.tensor(v))
        if rescaler is None:
            rescaler = np.ones(self.channels, np.float32)
        self.register_buffer("rescaler", torch.from_numpy(
            np.asarray(rescaler, np.float32)[: self.channels].copy()), persistent=False)
        mask = np.ones((*self.model_shape, 1), np.float32)
        mask[self.coef_shape[0]:] = 0
        mask[:, self.coef_shape[1]:] = 0
        mask[:, :, self.coef_shape[2]:] = 0
        self.register_buffer("pad_mask", torch.from_numpy(mask), persistent=False)
        self.model = Unet3d(dim=dim, out_channels=self.channels, dim_mults=dim_mults,
                            channels=self.channels, in_time=self.model_shape[0],
                            out_time=self.model_shape[0], compute_dtype=compute_dtype,
                            remat=remat, device=device, generator=generator)
        self.to(device)

    @property
    def dtype(self) -> torch.dtype:
        """The pipeline's dtype: float32, or float64 after ``.double()``."""
        return self.betas.dtype

    @property
    def remat(self) -> bool:
        return self.model.remat

    # ---------------- coefficient packing ----------------

    def to_coef_tensor(self, data: torch.Tensor) -> torch.Tensor:
        """data [b, f, h, w, c] → padded, rescaled [b, T', H', W', c·8]."""
        b, c = data.shape[0], data.shape[-1]
        flat = data.movedim(-1, 1).reshape(b * c, *data.shape[1:4]).to(self.dtype)
        coefs = wavedec3_level1(flat, self.wave_type).reshape(b, c * 8, *self.coef_shape)
        coefs = torch.nn.functional.pad(
            coefs, (0, self.pad_x, 0, self.pad_x, 0, self.pad_t))
        return coefs.movedim(1, -1) / self.rescaler[: c * 8].to(self.dtype)

    def from_coef_tensor(self, state: torch.Tensor) -> torch.Tensor:
        """Inverse: [b, T', H', W', C·8] (normalized) → [b, *shape_out]."""
        b, c = state.shape[0], self.c_in + self.c_out
        coefs = (state * self.rescaler.to(self.dtype)).movedim(-1, 1)
        coefs = coefs[..., : self.coef_shape[0], : self.coef_shape[1], : self.coef_shape[2]]
        rec = waverec3_level1(coefs.reshape(b * c, 8, *self.coef_shape), self.wave_type)
        rec = rec.reshape(b, c, *rec.shape[1:])
        f, h, w, _ = self.shape_in
        pred = rec[:, self.c_in:, :f, :h, :w]                   # [b, c_out, f, h, w]
        c_t = self.shape_out[-1]
        pred = pred.reshape(b, c_t, self.c_out // c_t, f, h, w)
        return pred.permute(0, 2, 3, 4, 5, 1).reshape(b, *self.shape_out)

    def set_conditions(self, state: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """The input-coefficient channels clamped to ``cond``, the padding to 0."""
        state = torch.cat([cond, state[..., cond.shape[-1]:]], dim=-1)
        return state * self.pad_mask.to(state.dtype)

    # ---------------- draws ----------------

    def _normal(self, shape, device) -> torch.Tensor:
        g = self.dropout_generator(device)
        return torch.randn(tuple(shape), generator=g, device=device).to(self.dtype)

    def _extract(self, buf: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
        return buf[t].reshape(t.shape[0], *([1] * (ndim - 1)))

    # ---------------- training ----------------

    def loss(self, x: torch.Tensor, y: torch.Tensor, t: torch.Tensor | None = None,
             noise: torch.Tensor | None = None, reference: bool = False) -> torch.Tensor:
        """The DDPM loss: the mean squared error of the predicted noise.
        ``t`` [b] and ``noise`` [b, T', H', W', C·8] are drawn from the
        model's generator unless given."""
        b = x.shape[0]
        if t is None:
            t = torch.randint(0, self.num_timesteps, (b,),
                              generator=self.dropout_generator(x.device), device=x.device)
        state_start = self.to_coef_tensor(pack_input_target(x, y))
        cond = state_start[..., : 8 * self.c_in]
        noise = (self._normal(state_start.shape, x.device) if noise is None
                 else noise.to(state_start))
        t = t.to(x.device)
        nd = state_start.dim()
        state = (self._extract(self.sqrt_alphas_cumprod, t, nd) * state_start
                 + self._extract(self.sqrt_one_minus_alphas_cumprod, t, nd) * noise)
        state = self.set_conditions(state, cond)
        target = self.set_conditions(noise, torch.zeros_like(cond))
        return mse(self.model(state, reference=reference), target)

    # ---------------- sampling ----------------

    def n_draws(self) -> int:
        """Gaussian draws a sample takes: the initial state, then one a DDIM
        step with a next time, or one an ancestral step."""
        if self.is_ddim:
            return 1 + sum(1 for _, nxt in self.ddim_pairs() if nxt >= 0)
        return 1 + self.num_timesteps

    def ddim_pairs(self) -> list:
        total, steps = self.num_timesteps, self.sampling_timesteps
        times = np.linspace(-1, total - 1, steps + 1).astype(int).tolist()
        return list(zip(reversed(times[1:]), reversed(times[:-1])))

    def sample(self, x: torch.Tensor, draws: Sequence[torch.Tensor] | None = None,
               reference: bool = False) -> torch.Tensor:
        """The generative rollout: input window → predicted output window.
        ``draws`` (``n_draws()`` tensors of the state's shape) replace the
        generator's."""
        cond = self.to_coef_tensor(x)[..., : 8 * self.c_in]
        shape = (x.shape[0], *self.model_shape, self.channels)
        it = iter(draws) if draws is not None else None
        normal = (lambda: self._normal(shape, x.device)) if it is None else \
            (lambda: next(it).to(device=x.device, dtype=self.dtype))
        img = normal()
        denoise = lambda s: self.model(s, reference=reference).to(self.dtype)
        img = (self._ddim_loop if self.is_ddim else self._ancestral_loop)(
            denoise, img, cond, normal)
        return self.from_coef_tensor(self.set_conditions(img, cond))

    def _ddim_loop(self, denoise, img, cond, normal):
        sched, eta = self.schedule, self.ddim_eta
        for time, time_next in self.ddim_pairs():
            img = self.set_conditions(img, cond)
            eps = denoise(img)
            # host scalars from the float32 entries, as the JAX loop takes them
            sr = float(sched.sqrt_recip_alphas_cumprod[time])
            srm1 = float(sched.sqrt_recipm1_alphas_cumprod[time])
            x_start = torch.clamp(sr * img - srm1 * eps, -1.0, 1.0)
            eps = (sr * img - x_start) / srm1
            if time_next < 0:
                img = x_start
                continue
            alpha = sched.alphas_cumprod[time]
            alpha_next = sched.alphas_cumprod[time_next]
            sigma = eta * math.sqrt((1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha))
            cc = math.sqrt(max(1 - alpha_next - sigma ** 2, 0.0))
            img = x_start * math.sqrt(alpha_next) + cc * eps + sigma * normal()
        return img

    def _ancestral_loop(self, denoise, img, cond, normal):
        nd = img.dim()
        for t in range(self.num_timesteps - 1, -1, -1):
            img = self.set_conditions(img, cond)
            t_b = torch.full((img.shape[0],), t, dtype=torch.long, device=img.device)
            ex = lambda buf: self._extract(buf, t_b, nd)
            eps = denoise(img)
            x_start = torch.clamp(ex(self.sqrt_recip_alphas_cumprod) * img
                                  - ex(self.sqrt_recipm1_alphas_cumprod) * eps, -1.0, 1.0)
            mean = (ex(self.posterior_mean_coef1) * x_start
                    + ex(self.posterior_mean_coef2) * img)
            noise = normal()
            if t == 0:
                noise = torch.zeros_like(noise)
            img = mean + torch.exp(0.5 * ex(self.posterior_log_variance_clipped)) * noise
        return img

    def forward(self, x: torch.Tensor, y: torch.Tensor | None = None,
                reference: bool = False) -> torch.Tensor:
        """The sample of ``x``'s output window, or, given the target ``y``,
        the DDPM loss. ``reference=True``: the denoiser's plain twin."""
        if y is None:
            return self.sample(x, reference=reference)
        return self.loss(x, y, reference=reference)
