"""Sampled (U-statistic) KSD-VI: ``SampledKSDVariationalInference.train``.

Its shots come from the engine's default sampler,
``sim.sampling.inverse_cdf_sampler``, called through a recorder that, in
the first steps only, keeps the sampling generator's state before each
draw and the shots drawn, so that the reference can draw again from the
same uniforms and score the same shots.
"""

from __future__ import annotations

from portbench.drivers.base import Driver

# The faults of faults.py that this path can have.
FAULTS = ("unchanged", "half_batch", "altered_q", "altered_shots")


class _Recorder:
    def __init__(self, sampler):
        self.sampler = sampler
        self.on = False
        self.states, self.shots = [], []

    def __call__(self, P, num_samples, generator):
        if self.on:
            self.states.append(generator.get_state())
        out = self.sampler(P, num_samples, generator)
        if self.on:
            flat = out[0] if isinstance(out, tuple) else out
            self.shots.append(flat.detach().clone())
        return out


class SampledKSD(Driver):
    def make_engine(self):
        from tensornetworks_tpu_torch.engines import SampledKSDVariationalInference
        from tensornetworks_tpu_torch.sim.sampling import inverse_cdf_sampler

        p = self.problem
        self.recorder = _Recorder(inverse_cdf_sampler)
        return SampledKSDVariationalInference(
            self.bn, self.latent, list(self.observed), qbm_ansatz_layers=p["layers"],
            qbm_ansatz_type=p["ansatz"], qbm_init_method="small_random",
            num_samples=p["num_samples"], seed=p["program_seed"],
            base_kernel_length_scale=p["length_scale"], sampling=p["sampling"],
            grad_baseline=p["grad_baseline"],
            device=self.device)

    def train_kwargs(self) -> dict:
        return {"sampler": self.recorder}

    def first_steps(self, steps: int) -> dict:
        self.recorder.on = True
        try:
            record = super().first_steps(steps)
        finally:
            self.recorder.on = False
        record["gen_states"] = list(self.recorder.states)
        record["shots"] = [s.cpu().numpy() for s in self.recorder.shots]
        self.recorder.states, self.recorder.shots = [], []
        return record


DRIVER = SampledKSD
