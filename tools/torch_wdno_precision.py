"""How far an f32 WDNO sample lies from its float64 replay, on the CPU.

WDNO's first DDIM step (t 999 of the sigmoid schedule over 1000 steps)
multiplies the denoiser's rounding by sqrt(1/abar - 1) = 1825 before the clip
to +-1, so two f32 paths that agree to f32 rounding in one forward (the TA
kernels and their plain twin) may sit further apart after a sample. This
script builds the port's WDNO at the shipped schedule (DDIM 10 steps, eta 1)
with a denoiser of the given width on a small window, copies it to float64
(every layer built in float64), samples both from the same draws, and
prints per seed the sample's relative L2 and max|d|/max|ref| distance
from the float64 replay, beside the first denoiser forward's; with
``--bf16``, also the bf16 denoiser's sample against the f32 one.

    PYTHONPATH=. python tools/torch_wdno_precision.py [--dim 256]
        [--window 20,16,32,3] [--seeds 2] [--bf16]

The limits of chip_smoke.py's wdno_sample phases were set from its
readings at dim 64 and 256 on a 20x16x32x3 window.
"""

import argparse
import json

import torch

from realpdebench_tpu_torch.models.wdno import WDNO
from realpdebench_tpu_torch.utils.misc import make_generator


def distance(a: torch.Tensor, b: torch.Tensor) -> dict:
    a, b = a.double(), b.double()
    return dict(rel_l2=((a - b).norm() / b.norm()).item(),
                max_abs_over_max_ref=((a - b).abs().max() / b.abs().max()).item())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--window", default="20,16,32,3")
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--bf16", action="store_true")
    args = ap.parse_args()
    shape = tuple(int(v) for v in args.window.split(","))
    kw = dict(dim=args.dim, dim_mults=(1, 2), wave_type="bior1.1", beta_schedule="sigmoid",
              timesteps=1000, sampling_timesteps=10, ddim_eta=1.0)
    for seed in range(args.seeds):
        m = WDNO(shape, shape, generator=make_generator(seed), **kw)
        ref = WDNO(shape, shape, compute_dtype=torch.float64, **kw).double()
        ref.load_state_dict(m.state_dict())
        g = torch.Generator().manual_seed(seed)
        x = torch.randn(2, *shape, generator=g)
        draws = [torch.randn(2, *m.model_shape, m.channels, generator=g)
                 for _ in range(m.n_draws())]
        with torch.inference_mode():
            cond = m.to_coef_tensor(x)[..., : 8 * m.c_in]
            state = m.set_conditions(draws[0], cond)
            row = dict(dim=args.dim, window=shape, seed=seed,
                       sample_f32_vs_f64=distance(m.sample(x, draws=draws),
                                                  ref.sample(x.double(), draws=draws)),
                       first_forward_f32_vs_f64=distance(m.model(state),
                                                         ref.model(state.double())))
            if args.bf16:
                half = WDNO(shape, shape, compute_dtype=torch.bfloat16, **kw)
                half.load_state_dict(m.state_dict())
                row["sample_bf16_vs_f32"] = distance(half.sample(x, draws=draws),
                                                     m.sample(x, draws=draws))
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
