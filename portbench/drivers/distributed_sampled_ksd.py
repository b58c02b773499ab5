"""Sampled (U-statistic) KSD-VI with the state sharded over the cell's
ranks: ``DistributedSampledKSDVariationalInference.train``, one rank a
device (the harness's ``Ranks``).

The engine is shot for shot the single-card engine with two-stage
sampling from the same seed. In the first steps only, a recorder keeps
the state of the shot generator before each epoch's uniforms and the
shots the sharded sampler drew, so that the reference can draw again from
the same uniforms and score the same shots. ``end_state`` gives this
rank's block of q, the states ``q_range`` of the state's index that its
shard holds.
"""

from __future__ import annotations

import contextlib

import torch

from portbench.drivers.base import Driver

# The faults of faults.py that this path can have.
FAULTS = ("unchanged", "half_batch", "altered_q", "altered_shots", "exchange_self")

ENGINE = "tensornetworks_tpu_torch.engines.distributed_sampled"


class DistributedSampledKSD(Driver):
    def make_engine(self):
        from tensornetworks_tpu_torch.engines.distributed_sampled import (
            DistributedSampledKSDVariationalInference)

        p = self.problem
        if p["sampling"] != "two_stage":
            raise ValueError(f"the distributed engine samples two-stage, not {p['sampling']!r}")
        return DistributedSampledKSDVariationalInference(
            self.bn, self.latent, list(self.observed), qbm_ansatz_layers=p["layers"],
            qbm_ansatz_type=p["ansatz"], qbm_init_method="small_random",
            base_kernel_length_scale=p["length_scale"], num_samples=p["num_samples"],
            seed=p["program_seed"], grad_baseline=p["grad_baseline"], device=self.device)

    def first_steps(self, steps: int) -> dict:
        import importlib

        engine_mod = importlib.import_module(ENGINE)
        states, shots = [], []
        draw, make_sampler = engine_mod.draw_uniforms, engine_mod.make_distributed_two_stage_sampler

        def recorded_draw(gen, *args, **kwargs):
            if len(states) == len(shots):   # the epoch's first draw: the row uniforms
                states.append(gen.get_state())
            return draw(gen, *args, **kwargs)

        def recorded_sampler(*args, **kwargs):
            sample = make_sampler(*args, **kwargs)

            def recorded(*a):
                idx, q_at = sample(*a)
                shots.append(idx.detach().clone())
                return idx, q_at
            return recorded

        with contextlib.ExitStack() as stack:
            for name, value in (("draw_uniforms", recorded_draw),
                                ("make_distributed_two_stage_sampler", recorded_sampler)):
                stack.callback(setattr, engine_mod, name, getattr(engine_mod, name))
                setattr(engine_mod, name, value)
            record = super().first_steps(steps)
        record["gen_states"] = states
        record["shots"] = [s.cpu().numpy() for s in shots]
        return record

    def end_state(self) -> dict:
        """The parameters the window left, and this rank's block of q at
        them (float32, on its device) with its range of the state's index."""
        from tensornetworks_tpu_torch.engines.common import highest_matmul_precision
        from tensornetworks_tpu_torch.parallel import distributed_ansatz
        from tensornetworks_tpu_torch.parallel.mesh import STATE_AXIS, axis_index

        e, p = self.engine, self.problem
        probs = distributed_ansatz.make_distributed_ansatz_probs(
            e.mesh, p["n"], p["layers"], p["ansatz"], edges=e.edges)
        params = e.params.detach()
        with torch.no_grad(), highest_matmul_precision():
            q = probs(params).float()
        lo = axis_index(e.mesh, STATE_AXIS) * q.numel()
        return {"theta_end": params.double().cpu().numpy(), "q_end": q,
                "q_range": (lo, lo + q.numel())}


DRIVER = DistributedSampledKSD
