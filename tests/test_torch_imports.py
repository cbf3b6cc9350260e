"""The port stands alone: importing every module of realpdebench_tpu_torch
(the Arrow data layer, the converter, the plots, the surrogate pipeline,
DPOT, WDNO with its wavelet transform, DMD, the parity CLI and the
simulation generators among them)
loads neither JAX nor the JAX package, nor the data layer's optional
packages (datasets, pyarrow, huggingface_hub, h5py, matplotlib), and
running it on the CPU (the FNO, the UNet, the Galerkin Transformer,
DeepONet, Transolver, DPOT, CNO in both activation modes, MWT, WDNO, DMD
and the 2-D and 3-D solvers) never builds or loads the CUDA kernels.
Checked in a fresh interpreter, since this test process has both packages
loaded."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys
    import realpdebench_tpu_torch as pkg
    from realpdebench_tpu_torch.ops import kernels

    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for n in names:
        importlib.import_module(n)
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith("jax.") or m == "realpdebench_tpu"
                 or m.startswith("realpdebench_tpu."))
    assert not bad, bad
    # the data layer's optional packages load only where they are used
    lazy = sorted(m for m in ("datasets", "pyarrow", "huggingface_hub", "h5py",
                              "matplotlib") if m in sys.modules)
    assert not lazy, lazy
    for n in ("data.hf_datasets", "data.hf_download", "tools.convert_hdf5_to_hf",
              "eval.plots", "eval.probes", "data.surrogate", "train.surrogate",
              "tools.generate_surrogate_data", "tools.numerical_real_compare",
              "models.dpot", "models.dpot3d", "models.cno", "models.mwt",
              "ops.filtered_lrelu", "ops.multiwavelet", "models.wdno", "ops.wavelet",
              "models.dmd", "eval.parity", "sim.ns2d", "sim.ns3d", "sim.env",
              "sim.generate"):
        assert pkg.__name__ + "." + n in names, n

    def refuse_build():
        raise AssertionError("CUDA kernels built during a CPU run")
    kernels.build = refuse_build

    import torch
    from realpdebench_tpu_torch.data.normalizer import IdentityNormalizer
    from realpdebench_tpu_torch.eval.rollout import make_rollout_fn
    from realpdebench_tpu_torch.models.registry import build_model
    from realpdebench_tpu_torch.utils.misc import make_generator

    m = build_model(shapes=((4, 8, 8, 3), (4, 8, 8, 3)), model_name="fno",
                    modes1=2, modes2=2, modes3=2, n_layers=2, width=8,
                    device="cpu", generator=make_generator(0))
    pred, _, _ = make_rollout_fn(m, IdentityNormalizer(), 2)(
        torch.zeros(1, 4, 8, 8, 3), torch.zeros(1, 8, 8, 8, 3))
    assert pred.shape == (1, 8, 8, 8, 3) and bool(torch.isfinite(pred).all())
    u = build_model(shapes=((2, 8, 8, 3), (2, 8, 8, 3)), model_name="unet",
                    dim_mults=[1, 2], device="cpu", generator=make_generator(0))
    pred, _, _ = make_rollout_fn(u, IdentityNormalizer(), 2)(
        torch.zeros(1, 2, 8, 8, 3), torch.zeros(1, 4, 8, 8, 3))
    assert pred.shape == (1, 4, 8, 8, 3) and bool(torch.isfinite(pred).all())
    u.loss(torch.zeros(1, 2, 8, 8, 3), torch.ones(1, 2, 8, 8, 3)).backward()
    gk = build_model(shapes=((2, 8, 8, 3), (2, 8, 8, 3)),
                     model_name="galerkin_transformer", n_hidden=32,
                     num_encoder_layers=1, n_head=2, dim_feedforward=16,
                     fourier_modes_x=2, fourier_modes_y=2, fourier_modes_t=2,
                     freq_dim=8, device="cpu", generator=make_generator(0))
    pred, _, _ = make_rollout_fn(gk, IdentityNormalizer(), 1)(
        torch.zeros(1, 2, 8, 8, 3), torch.zeros(1, 2, 8, 8, 3))
    assert pred.shape == (1, 2, 8, 8, 3) and bool(torch.isfinite(pred).all())
    gk.loss(torch.ones(1, 2, 8, 8, 3), torch.zeros(1, 2, 8, 8, 3)).backward()
    don = build_model(shapes=((2, 8, 8, 3), (2, 8, 8, 3)), model_name="deeponet", p=8,
                      dropout_rate=0.1, device="cpu", generator=make_generator(0))
    pred, _, _ = make_rollout_fn(don, IdentityNormalizer(), 2)(
        torch.zeros(1, 2, 8, 8, 3), torch.zeros(1, 4, 8, 8, 3))
    assert pred.shape == (1, 4, 8, 8, 3) and bool(torch.isfinite(pred).all())
    don.loss(torch.ones(2, 2, 8, 8, 3), torch.zeros(2, 2, 8, 8, 3)).backward()
    tr = build_model(shapes=((2, 8, 8, 3), (2, 8, 8, 3)), model_name="transolver",
                     space_dim=3, n_layers=1, n_hidden=8, n_head=2, H=8, W=8, D=2,
                     fun_dim=0, out_dim=3, slice_num=4, device="cpu",
                     generator=make_generator(0))
    pred, _, _ = make_rollout_fn(tr, IdentityNormalizer(), 1)(
        torch.zeros(1, 2, 8, 8, 3), torch.zeros(1, 2, 8, 8, 3))
    assert pred.shape == (1, 2, 8, 8, 3) and bool(torch.isfinite(pred).all())
    tr.loss(torch.ones(1, 2, 8, 8, 3), torch.zeros(1, 2, 8, 8, 3)).backward()
    dp = build_model(shapes=((2, 8, 8, 3), (2, 8, 8, 3)), model_name="dpot", img_size=8,
                     in_channels=4, out_channels=4, in_timesteps=2, out_timesteps=2,
                     patch_size=4, embed_dim=16, depth=1, n_blocks=4, modes=2,
                     mlp_ratio=1, out_layer_dim=8, device="cpu",
                     generator=make_generator(0))
    pred, _, _ = make_rollout_fn(dp, IdentityNormalizer(), 1)(
        torch.zeros(1, 2, 8, 8, 3), torch.zeros(1, 2, 8, 8, 3))
    assert pred.shape == (1, 2, 8, 8, 3) and bool(torch.isfinite(pred).all())
    dp.loss(torch.ones(1, 2, 8, 8, 3), torch.zeros(1, 2, 8, 8, 3)).backward()
    for act in ("LeakyReLU", "lrelu"):
        cno = build_model(shapes=((2, 8, 8, 3), (2, 8, 8, 3)), model_name="cno",
                          N_layers=1, N_res_neck=1, channel_multiplier=4,
                          latent_lift_proj_dim=4, activation=act, device="cpu",
                          generator=make_generator(0))
        pred, _, _ = make_rollout_fn(cno, IdentityNormalizer(), 1)(
            torch.zeros(1, 2, 8, 8, 3), torch.zeros(1, 2, 8, 8, 3))
        assert pred.shape == (1, 2, 8, 8, 3) and bool(torch.isfinite(pred).all())
        cno.loss(torch.ones(2, 2, 8, 8, 3), torch.zeros(2, 2, 8, 8, 3)).backward()
    mwt = build_model(shapes=((2, 8, 16, 3), (2, 8, 16, 3)), model_name="mwt", k=2,
                      alpha=2, c=1, nCZ=1, device="cpu", generator=make_generator(0))
    pred, _, _ = make_rollout_fn(mwt, IdentityNormalizer(), 1)(
        torch.zeros(1, 2, 8, 16, 3), torch.zeros(1, 2, 8, 16, 3))
    assert pred.shape == (1, 2, 8, 16, 3) and bool(torch.isfinite(pred).all())
    mwt.loss(torch.ones(1, 2, 8, 16, 3), torch.zeros(1, 2, 8, 16, 3)).backward()
    wd = build_model(shapes=((4, 8, 8, 2), (4, 8, 8, 2)), model_name="wdno", dim=8,
                     wave_type="bior1.1", timesteps=20, sampling_timesteps=2,
                     device="cpu", generator=make_generator(0))
    pred, _, _ = make_rollout_fn(wd, IdentityNormalizer(), 1)(
        torch.zeros(1, 4, 8, 8, 2), torch.zeros(1, 4, 8, 8, 2))
    assert pred.shape == (1, 4, 8, 8, 2) and bool(torch.isfinite(pred).all())
    wd.loss(torch.ones(1, 4, 8, 8, 2), torch.zeros(1, 4, 8, 8, 2)).backward()
    dmd = build_model(shapes=((4, 8, 8, 3), (4, 8, 8, 3)), model_name="dmd", n_modes=2,
                      n_predict=4, input_feature=2, N_autoregressive=1, device="cpu")
    pred, _, _ = make_rollout_fn(dmd, IdentityNormalizer(), 1)(
        torch.rand(1, 4, 8, 8, 3), torch.zeros(1, 4, 8, 8, 3))
    assert pred.shape == (1, 4, 8, 8, 2) and bool(torch.isfinite(pred).all())
    from realpdebench_tpu_torch.sim import ns2d, ns3d
    frames, cd, _ = ns2d.simulate(ns2d.SolverConfig(nx=16, ny=16), None, 2, 1,
                                  noise=torch.zeros(16, 16), device="cpu")
    assert frames.shape == (2, 16, 16, 3) and bool(torch.isfinite(cd).all())
    foil = ns3d.simulate_foil(ns3d.Solver3DConfig(nx=8, ny=8, nz=4), torch.Generator(), 1, 1,
                              device="cpu")
    assert foil.shape == (1, 8, 8, 3) and bool(torch.isfinite(foil).all())
    assert kernels.library.cache_info().currsize == 0
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES
    assert len(names) >= 21, names
    print("OK", len(names))
""")


def test_port_imports_no_jax_and_builds_nothing_on_cpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("OK")
