"""Autoregressive rollout, the evaluation hot loop.

Counterpart of ``realpdebench_tpu/eval/rollout.py``; the JAX ``lax.scan``
becomes a Python loop. Starting from the normalized input window, repeat
``n_steps`` times:
    p = model(window)                          # normalized prediction
    p_phys = postprocess_target(p)             # back to physical units
    if control: p_phys = cat(p_phys, raw control channels)
    window = preprocess_input(p_phys)          # re-normalize input-side
and return the time-concatenated windows with the control channels
stripped.
"""

from __future__ import annotations

import torch


def make_rollout_fn(model, normalizer, n_steps: int, para_c: int = 0):
    """Build ``rollout(x_raw, y_raw) -> (pred_norm, xn, yn)``.

    ``model`` is anything with ``predict(window)`` (a ``models.base.Model``).
    pred_norm: [B, n_steps*T_out, H, W, C_target], normalized.
    ``para_c`` > 0 re-injects that many raw control channels (the last
    channels of the input) after every step (controlled_cylinder).
    """

    def rollout(x_raw: torch.Tensor, y_raw: torch.Tensor):
        x_raw = x_raw.float()
        y_raw = y_raw.float()
        para_input = x_raw[..., x_raw.shape[-1] - para_c:] if para_c else None
        xn, yn = normalizer.preprocess(x_raw, y_raw)
        window = xn
        preds = []
        for _ in range(n_steps):
            p = model.predict(window)
            _, p_phys = normalizer.postprocess(window, p)
            if para_c:
                p_phys = torch.cat([p_phys, para_input], dim=-1)
            window, _ = normalizer.preprocess(p_phys, yn)
            preds.append(window)
        pred = torch.cat(preds, dim=1)
        if para_c:
            pred = pred[..., :-para_c]
        return pred, xn, yn

    return rollout


def finalize_rollout(normalizer, pred_norm, xn, yn, c: int):
    """Normalized MSE on the first ``c`` channels, plus the physical-unit
    prediction and target."""
    nmse = torch.mean((pred_norm[..., :c] - yn[..., :c]) ** 2)
    _, pred_phys = normalizer.postprocess(xn, pred_norm)
    _, target_phys = normalizer.postprocess(xn, yn)
    return nmse, pred_phys, target_phys
