"""DPOT's spectral resize on the card: cuFFT's multi-axis inverse
(``torch.fft.irfft2``) against ``models.dpot.irfftn`` (the inverse as the
JAX package's dense-DFT route defines it), each in float32 against the
same computation in float64, on cylinder-sized frames (2 windows of 20
frames × 3 channels at 64x128, resized to DPOT's 128x128 and back).

    PYTHONPATH=. python3 tools/torch_dpot_fft_probe.py

Prints one JSON line: for each inverse, the relative L2 distance of the
float32 result from the float64 one after the resize up and after the
resize back, and the distance between the two inverses in float64.
"""

import json

import torch

from realpdebench_tpu_torch.models import dpot


def resize(x, out_size, inverse):
    """``dpot.fft_resize_2d`` with the inverse transform ``inverse(z, s)``."""
    H, W = x.shape[1], x.shape[2]
    Ho, Wo = out_size
    f = torch.fft.rfft2(x.movedim(-1, 1))
    top1, top2 = min((H + 1) // 2, (Ho + 1) // 2), min(f.shape[-1], Wo // 2 + 1)
    bot1 = min(H // 2, Ho // 2)
    z = f.new_zeros((*f.shape[:-2], Ho, Wo // 2 + 1))
    z[..., :top1, :top2] = f[..., :top1, :top2]
    if bot1:
        z[..., -bot1:, :top2] = f[..., -bot1:, :top2]
    return (inverse(z, (Ho, Wo)) * (Ho / H) * (Wo / W)).movedim(1, -1)


INVERSES = {
    "torch.fft.irfft2": lambda z, s: torch.fft.irfft2(z, s=s),
    "dpot.irfftn": lambda z, s: dpot.irfftn(z, s, (-2, -1)),
}


def main() -> None:
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(2, 64, 128, 60, generator=g, device=dev)
    rel = lambda a, b: ((a.double() - b).norm() / b.norm()).item()
    out, ref = {}, {}
    for name, inv in INVERSES.items():
        up32, up64 = resize(x, (128, 128), inv), resize(x.double(), (128, 128), inv)
        back32, back64 = resize(up32, (64, 128), inv), resize(up64, (64, 128), inv)
        out[name] = dict(up_rel_l2=rel(up32, up64), back_rel_l2=rel(back32, back64))
        ref[name] = back64
    a, b = ref.values()
    out["float64_inverses_rel_l2"] = ((a - b).norm() / b.norm()).item()
    print(json.dumps(dict(device=torch.cuda.get_device_name(0), **out)), flush=True)


if __name__ == "__main__":
    main()
