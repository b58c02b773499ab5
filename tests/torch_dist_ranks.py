"""Rank functions of the distributed tests (``tests/test_torch_*``).

``parallel.launch.spawn`` starts its ranks with the spawn method, so each
function runs in a fresh process that imports this module by name: it
imports torch and the port only, never JAX. Every function takes numpy
inputs made by a test from a seed, runs its cases on the CPU in float64
(one thread a rank, gloo), and returns numpy results (rank 0's is the one a
test sees); sharded results are gathered first.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from tensornetworks_tpu_torch.parallel import gather_full, make_mesh, state_shard
from tensornetworks_tpu_torch.parallel.comm import MeshReducer

F64, C128 = torch.float64, torch.complex128


def chain_score(n: int, seed: int = 0) -> np.ndarray:
    """The score table of the random chain network of n+1 variables with
    V{n}=1 observed (the scale problem), built by the port."""
    from tensornetworks_tpu_torch.core import get_random_chain_network
    from tensornetworks_tpu_torch.ops.stein import score_table

    bn = get_random_chain_network(n + 1, seed=seed)
    return score_table(bn.conditional_joint_table([f"V{i}" for i in range(n)], {f"V{n}": 1}))


def _np(t):
    return t.detach().cpu().numpy()


def _all_ranks(t) -> list:
    """``t`` (numpy) from every rank, in rank order."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, _np(t))
    return out


# --- tests/test_torch_shard_state.py ---------------------------------------

def shard_state_cases(inp: dict) -> dict:
    from tensornetworks_tpu_torch.parallel import (distributed_apply_1q, distributed_apply_cnot,
                                                   distributed_apply_cz, distributed_kron_matvec,
                                                   make_distributed_ansatz_probs)

    out = {}
    for dp in (1, 2):  # D = 4 and 2 state shards of the 4-rank world
        mesh = make_mesh(dp=dp)
        v7 = state_shard(torch.as_tensor(inp["v7"]), mesh)
        apply_1q = distributed_apply_1q(mesh, 7)
        for q in range(7):
            out[f"1q/D{4 // dp}/{q}"] = _np(gather_full(apply_1q(v7, torch.as_tensor(inp["U"]), q),
                                                        mesh))
        v6 = state_shard(torch.as_tensor(inp["v6"]), mesh)
        cnot, cz = distributed_apply_cnot(mesh, 6), distributed_apply_cz(mesh, 6)
        for c, t in inp["cnot_pairs"]:
            out[f"cnot/D{4 // dp}/{c},{t}"] = _np(gather_full(cnot(v6, c, t), mesh))
        for a, b in inp["cz_pairs"]:
            out[f"cz/D{4 // dp}/{a},{b}"] = _np(gather_full(cz(v6, a, b), mesh))
        mv = distributed_kron_matvec(mesh, inp["A"], 9)
        out[f"kron/D{4 // dp}"] = _np(gather_full(mv(state_shard(torch.as_tensor(inp["v9"]), mesh)),
                                                  mesh))
        for ansatz, params in inp["ansatz_params"].items():
            probs = make_distributed_ansatz_probs(mesh, 6, 2, ansatz, dtype=C128)
            q = probs(torch.as_tensor(params))
            out[f"ansatz/D{4 // dp}/{ansatz}"] = _np(gather_full(q, mesh))
            out[f"shard_len/D{4 // dp}/{ansatz}"] = q.shape[0]
    return out


# --- tests/test_torch_distributed_train.py ----------------------------------

def train_cases(inp: dict) -> dict:
    from tensornetworks_tpu_torch.engines.common import make_optimizer
    from tensornetworks_tpu_torch.parallel import (make_distributed_ansatz_probs,
                                                   make_distributed_ksd_train_step,
                                                   make_distributed_stein_matvec,
                                                   make_distributed_stein_quadform,
                                                   place_stein_tables)

    out = {}
    n = 6
    for dp in (1, 2):
        mesh = make_mesh(dp=dp)
        D = 4 // dp
        (S,) = place_stein_tables(mesh, inp["S6"], n, dtype=F64, device="cpu")
        mv = make_distributed_stein_matvec(mesh, n)
        q = state_shard(torch.as_tensor(inp["q6"]), mesh)
        out[f"matvec/D{D}"] = _np(gather_full(mv(q, S), mesh))
        quad = make_distributed_stein_quadform(mesh, n)
        qg = q.clone().requires_grad_(True)
        val = quad(qg, S)
        (g,) = torch.autograd.grad(val, qg)
        out[f"quad/D{D}"], out[f"quad_grad/D{D}"] = float(val), _np(gather_full(g, mesh))
        probs = make_distributed_ansatz_probs(mesh, n, 2, "hardware_efficient", dtype=C128)
        p = torch.as_tensor(inp["theta6"]).requires_grad_(True)
        loss = torch.sqrt(torch.clamp(quad(probs(p), S), min=1e-12))
        (g,) = torch.autograd.grad(loss, p)
        out[f"loss/D{D}"], out[f"loss_grad/D{D}"] = float(loss), _np(MeshReducer(mesh).grads(g))

    mesh = make_mesh(dp=1)
    (S7,) = place_stein_tables(mesh, inp["S7"], 7, dtype=F64, device="cpu")
    q7 = make_distributed_ansatz_probs(mesh, 7, 1, "hardware_efficient",
                                       dtype=C128)(torch.zeros(21, dtype=F64))
    out["memory"] = {"q": tuple(q7.shape), "S": tuple(S7.shape)}

    (S5,) = place_stein_tables(mesh, inp["S5"], 5, dtype=F64, device="cpu")
    opt = make_optimizer("adam", 5e-2, 10, use_lr_scheduler=False, gradient_clip_norm=None)
    step = make_distributed_ksd_train_step(mesh, 5, 2, "hardware_efficient", opt,
                                           state_dtype=C128)
    p = torch.as_tensor(inp["theta5"])
    st = opt.init(p)
    losses, steps = [], []
    for _ in range(6):
        p, st, loss = step(p, st, S5)
        losses.append(float(loss))
        steps.append(_np(p))
    out["step_losses"], out["step_params"] = losses, steps
    out["step_params_by_rank"] = _all_ranks(p)

    (S20,) = place_stein_tables(mesh, chain_score(20), 20, dtype=F64, device="cpu")
    mv20 = make_distributed_stein_matvec(mesh, 20)
    q20 = np.random.default_rng(inp["q20_seed"]).dirichlet(np.ones(2**20))
    out["matvec20"] = _np(gather_full(mv20(state_shard(torch.as_tensor(q20), mesh), S20), mesh))
    return out


# --- tests/test_torch_distributed_engine.py ---------------------------------

def _chain_problem(n, seed=0):
    from tensornetworks_tpu_torch.core import get_random_chain_network

    bn = get_random_chain_network(n + 1, seed=seed)
    return bn, [f"V{i}" for i in range(n)], {f"V{n}": 1}


def engine_cases(inp: dict) -> dict:
    from tensornetworks_tpu_torch.engines import distributed as dist_engine
    from tensornetworks_tpu_torch.parallel import make_distributed_ansatz_probs
    from tensornetworks_tpu_torch.runners import run_distributed_scale_experiment
    from tensornetworks_tpu_torch.sim import latent_edges

    out = {}
    Engine = dist_engine.DistributedQuantumKSDVariationalInference
    bn, latent, obs = _chain_problem(6)
    post = bn.posterior_vector(latent, obs)
    for dp in (1, 2):
        mesh = make_mesh(dp=dp)
        model = Engine(bn, latent, list(obs), qbm_num_latent_vars=6, qbm_ansatz_layers=2,
                       mesh=mesh, dtype=F64, state_dtype=C128, device="cpu")
        model.params = torch.as_tensor(inp["theta6"])
        h = model.train(obs, num_epochs=25, lr_born_machine=5e-3, verbose=False,
                        true_posterior_for_tvd=post)
        out[f"scan/D{4 // dp}"] = {"loss": h["loss_ksd"], "tvd": h["tvd"],
                                   "best_tvd": model.best_tvd_,
                                   "params_by_rank": _all_ranks(model.params)}

    mesh = make_mesh(dp=1)
    edges = latent_edges(bn, latent)
    p = torch.as_tensor(inp["theta_bn"])
    out["bn_edges"] = edges
    out["bn_probs"] = _np(gather_full(make_distributed_ansatz_probs(
        mesh, 6, 3, "bn_structured", dtype=C128, edges=edges)(p), mesh))
    out["bn_probs_cond"] = _np(gather_full(make_distributed_ansatz_probs(
        mesh, 6, 3, "bn_structured", dtype=C128, edges=edges, conditioning=True)(
            p, torch.as_tensor(inp["angles"])), mesh))

    bn5, latent5, obs5 = _chain_problem(5)
    post5 = bn5.posterior_vector(latent5, obs5)
    model = Engine(bn5, latent5, list(obs5), qbm_num_latent_vars=5, qbm_ansatz_layers=2,
                   qbm_ansatz_type="bn_structured", qbm_conditioning_dim=1, seed=0, mesh=mesh,
                   device="cpu")
    theta0 = _np(model.params)
    h = model.train(obs5, num_epochs=60, lr_born_machine=2e-2, verbose=False,
                    true_posterior_for_tvd=post5)
    out["cond"] = {"theta0": theta0, "edges": model.edges, "loss": h["loss_ksd"],
                   "best_tvd": model.best_tvd_}

    def make_model():
        return Engine(bn5, latent5, list(obs5), qbm_num_latent_vars=5, qbm_ansatz_layers=2,
                      seed=0, mesh=mesh, device="cpu")

    kw = dict(num_epochs=24, lr_born_machine=1e-2, verbose=False, true_posterior_for_tvd=post5,
              chunk_epochs=8)
    m_full = make_model()
    h_full = m_full.train(obs5, **kw)
    state = inp["resume_path"]
    m_int = make_model()
    orig = dist_engine.run_ksd_scan
    dist_engine.run_ksd_scan = lambda **a: orig(**a, fail_after_chunks=1)
    try:
        m_int.train(obs5, **kw, resume_state_path=state)
        killed = False
    except RuntimeError as e:
        killed = "fault injection" in str(e)
    finally:
        dist_engine.run_ksd_scan = orig
    import os

    existed = os.path.exists(state)
    dist.barrier()
    h_res = m_int.train(obs5, **kw, resume_state_path=state)
    dist.barrier()
    out["resume"] = {"killed": killed, "existed": existed, "removed": not os.path.exists(state),
                     "full": [h_full["loss_ksd"], h_full["tvd"], m_full.best_tvd_,
                              _np(m_full.params)],
                     "resumed": [h_res["loss_ksd"], h_res["tvd"], m_int.best_tvd_,
                                 _np(m_int.params)]}

    bn14, latent14, obs14 = _chain_problem(14)
    model = Engine(bn14, latent14, list(obs14), qbm_num_latent_vars=14, qbm_ansatz_layers=1,
                   qbm_ansatz_type="bn_structured", seed=0, mesh=mesh, device="cpu")
    (S,) = model.build_operator(obs14).args()
    with torch.no_grad():
        q = model._probs(model.params)
    h = model.train(obs14, num_epochs=2, lr_born_machine=1e-2, verbose=False)
    out["memory14"] = {"S": tuple(S.shape), "q": tuple(q.shape), "loss": h["loss_ksd"]}

    run = run_distributed_scale_experiment(num_qubits=5, layers=2, num_devices=4, verbose=False,
                                           ansatz="bn_structured",
                                           lr_phases=[(40, 0.05), (30, 0.005)], device="cpu")
    eng = run["model"]
    with torch.no_grad():
        q = gather_full(eng._probs(eng.params), mesh)
    out["phases"] = {"best_tvd": eng.best_tvd_, "tvd": float(0.5 * (q - torch.as_tensor(
        post5, dtype=q.dtype)).abs().sum()), "keys": sorted(run)}
    return out


# --- tests/test_torch_distributed_sampled.py --------------------------------

def sampled_cases(inp: dict) -> dict:
    from tensornetworks_tpu_torch.engines import DistributedSampledKSDVariationalInference
    from tensornetworks_tpu_torch.parallel import make_distributed_two_stage_sampler

    out = {}
    for dp in (1, 2):
        mesh = make_mesh(dp=dp)
        D = 4 // dp
        for name, suffix in (("P8", ""), ("P8_64", "64")):
            P = torch.as_tensor(inp[name])
            u_r, u_c = torch.as_tensor(inp["u_r" + suffix]), torch.as_tensor(inp["u_c" + suffix])
            sample = make_distributed_two_stage_sampler(mesh, 8, u_r.shape[0])
            idx, q_at = sample(state_shard(P, mesh), u_r, u_c)
            out[f"{name}/D{D}"] = (_np(idx), _np(q_at))
        P6 = state_shard(torch.as_tensor(inp["P6"]), mesh).clone().requires_grad_(True)
        sample = make_distributed_two_stage_sampler(mesh, 6, 64)
        idx, q_at = sample(P6, torch.as_tensor(inp["u6_r"]), torch.as_tensor(inp["u6_c"]))
        q_at.sum().backward()
        out[f"grad/D{D}"] = (_np(idx), _np(gather_full(P6.grad, mesh)))

    mesh = make_mesh(dp=1)
    bn, latent, obs = _chain_problem(7, seed=2)
    post = bn.posterior_vector(latent, obs)
    for baseline in ("loo", "mean", "none", "cv"):
        eng = DistributedSampledKSDVariationalInference(
            bn, latent, [f"V{7}"], qbm_ansatz_layers=2, num_samples=256, seed=0,
            grad_baseline=baseline, mesh=mesh, state_dtype=C128, dtype=F64, device="cpu")
        h = eng.train(obs, num_epochs=25, lr_born_machine=0.05, verbose=False,
                      true_posterior_for_tvd=post, reuse_loss_forward_for_eval=True)
        out[f"parity/{baseline}"] = {"loss": h["loss_ksd"], "tvd": h["tvd"],
                                     "best_tvd": eng.best_tvd_,
                                     "params_by_rank": _all_ranks(eng.params)}

    bn6, latent6, obs6 = _chain_problem(6, seed=2)
    post6 = bn6.posterior_vector(latent6, obs6)
    runs = []
    for chunk in (None, 15):
        eng = DistributedSampledKSDVariationalInference(bn6, latent6, ["V6"], qbm_ansatz_layers=2,
                                                        num_samples=128, seed=0, mesh=mesh,
                                                        device="cpu")
        h = eng.train(obs6, num_epochs=40, lr_born_machine=0.05, verbose=False,
                      true_posterior_for_tvd=post6, chunk_epochs=chunk)
        runs.append((h["loss_ksd"], eng.best_tvd_))
    out["chunked"] = runs

    bn4, latent4, obs4 = _chain_problem(4, seed=2)
    eng = DistributedSampledKSDVariationalInference(
        bn4, latent4, ["V4"], qbm_ansatz_layers=3, qbm_ansatz_type="bn_structured",
        num_samples=512, seed=0, grad_baseline="cv", mesh=mesh, device="cpu")
    eng.train(obs4, num_epochs=150, lr_born_machine=0.05, verbose=False,
              true_posterior_for_tvd=bn4.posterior_vector(latent4, obs4))
    out["converged_tvd"] = eng.best_tvd_
    return out


# --- tests/test_torch_amortized_mesh.py, tests/test_torch_amortized.py -------

def amortized_mesh_cases(inp: dict) -> dict:
    """On a dp-only mesh of the world: the classical amortized engine over
    8 observations, ``train_multi_seed`` over 8 seeds, and the per-seed
    guard with one poisoned seed."""
    from tensornetworks_tpu_torch.core import get_random_chain_network, get_sprinkler_network
    from tensornetworks_tpu_torch.engines import AmortizedKSD, train_multi_seed

    out = {}
    mesh = make_mesh(dp=dist.get_world_size())
    bn = get_random_chain_network(6, seed=3, num_observed=3)
    latent, observed = [f"V{i}" for i in range(3)], [f"V{i}" for i in range(3, 6)]
    eng = AmortizedKSD(bn, latent, observed, born_machine_config=inp["cfg"], dtype=F64,
                       device="cpu")
    h = eng.train(inp["observations"], num_epochs=60, lr=1e-2, verbose=False, seed=0, mesh=mesh)
    out["amortized"] = {"loss": h["loss"], "mean_tvd": h["mean_tvd"],
                        "best": eng.best_mean_tvd_,
                        "posteriors": [_np(eng.posterior_for(o)) for o in inp["observations"][:2]],
                        "params_by_rank": _all_ranks(eng.params)}
    sprinkler = get_sprinkler_network()
    p, tvd, loss = train_multi_seed(sprinkler, ["C", "S", "R"], {"W": 1}, num_seeds=8,
                                    ansatz_layers=2, num_epochs=80, base_seed=0, mesh=mesh,
                                    device="cpu")
    out["multi_seed"] = (_np(p), tvd, loss)
    p, tvd, loss = train_multi_seed(sprinkler, ["C", "S", "R"], {"W": 1}, num_seeds=4,
                                    ansatz_layers=2, num_epochs=30, base_seed=0, mesh=mesh,
                                    params0=inp["poisoned"], device="cpu")
    out["guard"] = (_np(p), tvd, loss)
    return out


def amortized_two_ranks(inp: dict) -> dict:
    """The conditioned quantum amortized engine and ``train_multi_seed`` on
    a 2-rank dp mesh."""
    from tensornetworks_tpu_torch.core import get_sprinkler_network
    from tensornetworks_tpu_torch.engines import AmortizedKSD, train_multi_seed
    from tensornetworks_tpu_torch.models import QuantumBornMachine

    mesh = make_mesh(dp=2)
    bn = get_sprinkler_network()
    qbm = QuantumBornMachine(3, inp["layers"], "hardware_efficient", dtype=F64, device="cpu",
                             conditioning_dim=1)
    eng = AmortizedKSD(bn, ["C", "S", "R"], ["W"], born_machine=qbm,
                       base_kernel_length_scale=inp["length_scale"])
    eng.params = torch.as_tensor(inp["params"])
    h = eng.train(inp["observations"], num_epochs=inp["epochs"], lr=inp["lr"], verbose=False,
                  mesh=mesh)
    seeds = train_multi_seed(bn, ["C", "S", "R"], {"W": 1}, num_seeds=2, ansatz_layers=2,
                             num_epochs=20, mesh=mesh, dtype=F64, device="cpu")
    return {"loss": h["loss"], "mean_tvd": h["mean_tvd"], "best": eng.best_mean_tvd_,
            "params": _np(eng.params), "seeds": (_np(seeds[0]), seeds[1], seeds[2])}


# --- tests/test_torch_parallel.py -------------------------------------------

def _error(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def parallel_cases(inp: dict) -> dict:
    from tensornetworks_tpu_torch.engines.common import make_optimizer
    from tensornetworks_tpu_torch.models import BinaryClassifierMLP, QuantumBornMachine
    from tensornetworks_tpu_torch.ops.stein import SteinOperator
    from tensornetworks_tpu_torch.parallel import (make_distributed_stein_matvec,
                                                   make_sharded_advi_classifier_step,
                                                   make_sharded_ksd_step, place_stein_tables)

    out = {"shapes": [tuple(make_mesh(4, dp=2).mesh.shape), tuple(make_mesh().mesh.shape)],
           "errors": [_error(lambda: make_mesh(8)), _error(lambda: make_mesh(4, dp=3))]}
    qbm = QuantumBornMachine(6, ansatz_layers=2, dtype=F64, device="cpu")
    for dense in (False, True):
        op = SteinOperator(inp["S6"], 6, dtype=F64, dense=dense, device="cpu")
        for dp in (1, 2):
            mesh = make_mesh(dp=dp)
            opt = make_optimizer("sgd", 5e-3, 10)
            step = make_sharded_ksd_step(qbm, op, mesh, opt)
            p = torch.as_tensor(inp["theta6"])
            p1, _, loss = step(p, opt.init(p))
            out[f"ksd_step/dense={dense}/D{4 // dp}"] = (float(loss), _np(p1))
    for dp in (1, 2):
        mesh = make_mesh(dp=dp)
        (S,) = place_stein_tables(mesh, inp["S_random"], 6, dtype=F64, device="cpu")
        y = make_distributed_stein_matvec(mesh, 6)(state_shard(torch.as_tensor(inp["q6"]), mesh),
                                                   S)
        out[f"matvec/D{4 // dp}"] = _np(gather_full(y, mesh))
    clf = BinaryClassifierMLP(input_dim=4, hidden_dims=[16, 8], dtype=F64, device="cpu")
    for dp in (2, 4):
        mesh = make_mesh(dp=dp)
        opt = make_optimizer("adam", 1e-2, 10)
        step = make_sharded_advi_classifier_step(clf, mesh, opt, batch_size=16, input_dim=4)
        p = torch.as_tensor(inp["clf_params"])
        p1, _, loss = step(p, opt.init(p), torch.as_tensor(inp["x"]), torch.as_tensor(inp["y"]))
        out[f"clf/dp{dp}"] = (float(loss), _np(p1))
    return out


def fail_on_rank(rank: int) -> None:
    """Rank ``rank`` raises; the others wait for it in a barrier."""
    if dist.get_rank() == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    dist.barrier()


def hang_on_rank(rank: int) -> None:
    """Rank ``rank`` never reaches the barrier the others wait in."""
    import time

    if dist.get_rank() == rank:
        time.sleep(3600)
    dist.barrier()
