"""Gym-style flow environment over the PyTorch NS solver.

Counterpart of ``realpdebench_tpu/sim/env.py`` (the reference drives a Java
LilyPad solver over XML-RPC): ``reset()``/``step(action)`` return the
flattened velocity field, and ``step`` the reward −|CD| and the force
coefficients, the body boundary and the pressure in ``info``. The solver
runs in-process on the device; ``action`` sets the body's surface velocity
(the rotation control of controlled_cylinder). Observations and ``info``
are numpy copies, one host synchronisation a step.
"""

from __future__ import annotations

import numpy as np
import torch

from realpdebench_tpu_torch.models.registry import resolve_device
from realpdebench_tpu_torch.sim.ns2d import (
    SolverConfig,
    cylinder_fraction,
    initial_state,
    make_stepper,
)
from realpdebench_tpu_torch.utils.misc import make_generator


class FlowEnv:
    def __init__(self, cfg: SolverConfig = SolverConfig(), substeps: int = 4,
                 seed: int = 0, *, device=None):
        self.cfg = cfg
        self.substeps = substeps
        self._seed = seed
        self.device = resolve_device(device, "FlowEnv runs")
        self._body = cylinder_fraction(cfg, device=self.device)
        self._step = make_stepper(cfg, device=self.device)
        self.state = None

    def _obs(self) -> np.ndarray:
        u, v = self.state
        return torch.stack((u, v), dim=-1).cpu().numpy().reshape(-1)

    def reset(self, noise=None):
        """The initial state from the generator seeded with ``seed`` (or from
        the injected standard normal draw ``noise`` [nx, ny])."""
        self.state = initial_state(self.cfg, make_generator(self._seed), noise=noise,
                                   device=self.device)
        return self._obs()

    def step(self, action: float = 0.0):
        # action = tangential surface speed (rotation control), applied as
        # the body's transverse velocity; for the uncontrolled env action == 0
        body_vel = (0.0, torch.tensor(action, dtype=torch.float32, device=self.device))
        for _ in range(self.substeps):
            self.state, (p, cd, cl) = self._step(self.state, self._body, body_vel)
        cd, cl = torch.stack((cd, cl)).tolist()
        info = {
            "cd": cd,
            "cl": cl,
            "body_boundary": self._body.cpu().numpy(),
            "pressure": p.cpu().numpy(),
        }
        done = False
        reward = -abs(cd)
        return self._obs(), reward, done, info
