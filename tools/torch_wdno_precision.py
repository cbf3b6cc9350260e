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
``--config`` takes the denoiser's width, levels, wavelet and DDIM length
from a shipped config (``dim`` and ``--dim`` then give way to it), and
``--window`` may give the input and the output window apart
(``T,H,W,C_in:T,H,W,C_out``: controlled_cylinder's two parameter planes).
``--device cuda`` runs the three on the card (its f32 model on the TA
kernels), adds the plain f32 path's sample (``reference=True``) and reads
the kernel sample's distance from it and the plain sample's from the
float64 replay; every sample there under cuDNN's deterministic algorithms.

    PYTHONPATH=. python tools/torch_wdno_precision.py [--dim 256]
        [--window 20,16,32,3] [--seeds 2] [--bf16]
    PYTHONPATH=. python tools/torch_wdno_precision.py
        --config controlled_cylinder/wdno.yaml --window 10,16,32,5:10,16,32,3
    python3 tools/torch_wdno_precision.py --device cuda --config
        combustion/wdno.yaml --window 20,64,64,16 --seeds 1      (on the card)

The limits of chip_smoke.py's wdno_sample phases were set from its
readings at dim 64 and 256 on a 20x16x32x3 window; those of its
scenarios phase from its readings at each scenario's config, at the
scenario's T and channels on a 16-wide window.
"""

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from realpdebench_tpu_torch.models.wdno import WDNO
from realpdebench_tpu_torch.utils.misc import make_generator, set_f32_precision


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
    ap.add_argument("--config", default=None)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    dev = torch.device(args.device)
    set_f32_precision()         # full f32 in cuDNN and cuBLAS, as build_model pins it
    torch.backends.cudnn.deterministic = True
    shape, shape_out = (tuple(int(v) for v in w.split(","))
                        for w in (args.window + ":" + args.window).split(":")[:2])
    kw = dict(dim=args.dim, dim_mults=(1, 2), wave_type="bior1.1", beta_schedule="sigmoid",
              timesteps=1000, sampling_timesteps=10, ddim_eta=1.0)
    if args.config:
        from realpdebench_tpu_torch.config import load_config

        cfg = load_config(args.config)
        kw.update(dim=int(cfg.dim), dim_mults=tuple(cfg.dim_mults), wave_type=cfg.wave_type,
                  beta_schedule=cfg.beta_schedule,
                  sampling_timesteps=int(cfg.sampling_timesteps),
                  ddim_eta=float(cfg.ddim_sampling_eta))
    for seed in range(args.seeds):
        m = WDNO(shape, shape_out, generator=make_generator(seed), device=dev, **kw)
        ref = WDNO(shape, shape_out, compute_dtype=torch.float64, device=dev, **kw).double()
        ref.load_state_dict(m.state_dict())
        g = torch.Generator().manual_seed(seed)
        x = torch.randn(2, *shape, generator=g).to(dev)
        draws = [torch.randn(2, *m.model_shape, m.channels, generator=g).to(dev)
                 for _ in range(m.n_draws())]
        with torch.inference_mode():
            cond = m.to_coef_tensor(x)[..., : 8 * m.c_in]
            state = m.set_conditions(draws[0], cond)
            # the float64 copy through the plain path (the kernels take f32)
            f32 = m.sample(x, draws=draws)
            f64 = ref.sample(x.double(), draws=draws, reference=True)
            row = dict(config=args.config, dim=kw["dim"], window=shape, window_out=shape_out,
                       seed=seed, ddim_steps=kw["sampling_timesteps"], device=str(dev),
                       sample_f32_vs_f64=distance(f32, f64),
                       first_forward_f32_vs_f64=distance(
                           m.model(state), ref.model(state.double(), reference=True)))
            if dev.type == "cuda":
                plain = m.sample(x, draws=draws, reference=True)
                row.update(sample_plain_f32_vs_f64=distance(plain, f64),
                           sample_f32_vs_plain_f32=distance(f32, plain))
            if args.bf16:
                half = WDNO(shape, shape_out, compute_dtype=torch.bfloat16, device=dev, **kw)
                half.load_state_dict(m.state_dict())
                row["sample_bf16_vs_f32"] = distance(half.sample(x, draws=draws),
                                                     m.sample(x, draws=draws))
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
