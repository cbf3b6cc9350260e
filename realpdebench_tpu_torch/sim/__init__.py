from realpdebench_tpu_torch.sim.ns2d import SolverConfig, make_stepper, simulate
