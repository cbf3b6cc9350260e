"""DMD — Dynamic Mode Decomposition, the training-free baseline.

Counterpart of ``realpdebench_tpu/models/dmd.py`` (reference
`realpdebench/model/dmd.py:22-219`), with its own numpy copy of the fit:
per sample, exact DMD on the input window (SVD of the snapshot pair,
eigendecomposition of the reduced operator, amplitudes from the initial
condition, the top ``n_modes`` by |amplitude|), then the modal forecast
x(t) = Σ bᵢ ψᵢ exp(λᵢ·t·0.0025) for the ``n_predict`` steps after the
window. Only the first ``input_feature`` channels are used and predicted.

On the host by design, as in the JAX package: a complex nonsymmetric
eigendecomposition has no kernel in either package, the model has no
parameters, and an eval costs a handful of small SVDs a batch. ``predict``
moves the window to the host and the forecast back to the window's device;
nothing else of the card is skipped.
"""

from __future__ import annotations

import numpy as np
import torch

from realpdebench_tpu_torch.models.base import Model


class DMD(Model):
    trainable = False

    def __init__(self, n_modes, n_predict, input_feature, n_autoregressive,
                 shape_out=None, rank=None):
        super().__init__()
        self.n_modes = n_modes
        self.n_predict = n_predict
        self.input_feature = input_feature
        self.N_autoregressive = n_autoregressive
        self.rank = rank
        self.shape_out = shape_out

    def _fit_predict(self, frames: np.ndarray) -> np.ndarray:
        """frames: (T, H, W, C) → forecast (n_predict, H, W, C)."""
        t_steps, h, w, c = frames.shape
        snaps = frames.reshape(t_steps, h * w * c).T  # (space, time)
        X1, X2 = snaps[:, :-1], snaps[:, 1:]

        U, s, Vt = np.linalg.svd(X1, full_matrices=False)
        rank = min(self.rank, len(s)) if self.rank is not None else len(s)
        U, s, Vt = U[:, :rank], s[:rank], Vt[:rank, :]

        S_inv = np.diag(1.0 / s)
        V = Vt.T
        A_tilde = U.T @ X2 @ V @ S_inv
        eigenvalues, W = np.linalg.eig(A_tilde)
        modes = X2 @ V @ S_inv @ W  # (space, rank)

        b = np.linalg.lstsq(modes, snaps[:, 0], rcond=None)[0]
        if self.n_modes is not None and self.n_modes < len(eigenvalues):
            idx = np.argsort(np.abs(b))[::-1][: self.n_modes]
            modes, eigenvalues, b = modes[:, idx], eigenvalues[idx], b[idx]

        # forecast t = T, ..., T+n_predict-1 with the reference's 0.0025 scale
        t = np.arange(t_steps, t_steps + self.n_predict, dtype=np.float64)
        growth = np.exp(np.outer(eigenvalues, t * 0.0025))  # (modes, steps)
        pred = (modes * b[None, :]) @ growth  # (space, steps)
        return pred.T.real.reshape(self.n_predict, h, w, c)

    def forecast(self, x) -> np.ndarray:
        """x: (B, T, H, W, C ≥ input_feature), numpy → (B, n_predict, H, W,
        input_feature) float32."""
        frames = np.asarray(x)[..., : self.input_feature]
        return np.stack([self._fit_predict(frames[i])
                         for i in range(frames.shape[0])]).astype(np.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The forecast of ``x``'s window, computed on the host and returned
        on ``x``'s device."""
        return torch.from_numpy(self.forecast(x.detach().cpu().numpy())).to(x.device)

    def loss(self, x, y):
        raise TypeError("DMD is training-free: it has no loss to train; evaluate it "
                        "with `python -m realpdebench_tpu_torch eval`")
