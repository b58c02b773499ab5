"""Attribution of device time to layers, on a hand-made trace."""

from portbench.trace import WINDOW, reduce_trace

LAYERS = {"circuit": {"modules": ["tensornetworks_tpu_torch/ops/kernels/circuit2d_grid.py"]},
          "sampled estimator": {"modules": ["tensornetworks_tpu_torch/sim/sampling.py"]},
          "engines": {"modules": ["tensornetworks_tpu_torch/engines/sampled.py"]}}


def ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def trace():
    py = "python_function"
    return {"traceEvents": [
        ev("user_annotation", WINDOW, 0, 1000),
        ev(py, "tensornetworks_tpu_torch/engines/sampled.py(10): epoch_loss", 10, 500,
           **{"Python id": 1, "Python parent id": None}),
        ev(py, "tensornetworks_tpu_torch/ops/kernels/circuit2d_grid.py(5): forward", 20, 100,
           **{"Python id": 2, "Python parent id": 1}),
        ev("cuda_runtime", "cudaLaunchKernel", 30, 5, correlation=7),
        ev(py, "tensornetworks_tpu_torch/sim/sampling.py(9): sample_indices_2d", 200, 100,
           **{"Python id": 3, "Python parent id": 1}),
        ev("cpu_op", "aten::cumsum", 210, 50, **{"External id": 3}),
        ev("cuda_runtime", "cudaLaunchKernel", 220, 5, correlation=8),
        ev("cpu_op", "aten::mul", 400, 20, **{"External id": 4}),
        ev("cuda_runtime", "cudaLaunchKernel", 405, 5, correlation=9),
        # Autograd thread: a C++ backward node with no frames, tied by a
        # forward-backward flow to the cumsum above.
        ev("cpu_op", "autograd::engine::evaluate_function: CumsumBackward0", 600, 80, tid=2),
        ev("cuda_runtime", "cudaLaunchKernel", 610, 5, tid=2, correlation=10),
        {"ph": "s", "cat": "fwdbwd", "id": 99, "tid": 1, "ts": 210, "name": "fwdbwd"},
        {"ph": "f", "cat": "fwdbwd", "id": 99, "tid": 2, "ts": 600, "name": "fwdbwd", "bp": "e"},
        ev("kernel", "circuit_kernel", 100, 300, tid=7, correlation=7),
        ev("kernel", "scan_kernel", 450, 50, tid=7, correlation=8),
        ev("kernel", "mul_kernel", 500, 100, tid=7, correlation=9),
        ev("kernel", "scan_bwd_kernel", 700, 100, tid=7, correlation=10),
    ]}


def test_layers_busy_and_gaps():
    r = reduce_trace(trace(), LAYERS)
    assert r.window_s == 1000e-6
    assert abs(r.layer_s["circuit"] - 300e-6) < 1e-12
    assert abs(r.layer_s["sampled estimator"] - 150e-6) < 1e-12
    assert abs(r.layer_s["engines"] - 100e-6) < 1e-12
    assert abs(r.busy_s - 550e-6) < 1e-12
    # Gaps: [0, 100), [400, 450), [600, 700), [800, 1000].
    assert [round(s * 1e6) for _, s in r.idle_gaps] == [200, 100, 100, 50]
    assert r.device_ops[0] == ("circuit_kernel", 300e-6)
