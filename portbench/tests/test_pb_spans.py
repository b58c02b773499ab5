"""The program's spans by ``reduce_spans``, on a hand-made trace."""

import pytest

from portbench.spans import NO_SPAN, Spans, blocked, checked, queued, reduce_spans
from portbench.trace import WINDOW

MAIN, BWD, STREAM = 1, 2, 7


def ev(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def span(name, ts, dur, tid=MAIN):
    return ev("user_annotation", name, ts, dur, tid)


def launch(ts, corr, tid=MAIN):
    return ev("cuda_runtime", "cudaLaunchKernel", ts, 2, tid, correlation=corr)


def kernel(name, ts, dur, corr):
    e = ev("kernel", name, ts, dur, STREAM, correlation=corr)
    e["pid"] = 0
    return e


def flow(ph, ts, tid):
    return {"ph": ph, "cat": "fwdbwd", "id": 5, "pid": 1, "tid": tid, "ts": ts, "name": "fwdbwd"}


def trace():
    return {"traceEvents": [
        span(WINDOW, 0, 1000),
        span("engine.posterior", 5, 3),   # opens in the first gap
        span("engine.epoch", 10, 890),
        span("engine.loss", 20, 280),
        span("born.fold", 30, 70),
        ev("cpu_op", "aten::einsum", 40, 20),
        launch(45, 1),
        span("circuit.forward", 120, 130),
        launch(130, 2),
        ev("cpu_op", "aten::mul", 255, 15),
        launch(260, 3),
        span("engine.backward", 300, 410),
        span("engine.sync", 800, 90),
        ev("cuda_runtime", "cudaStreamSynchronize", 805, 80),
        launch(950, 7),   # after the epoch: no span
        # Autograd's thread: the fold's backward node, tied to the einsum by
        # a flow; the circuit's own backward span; a node with no flow.
        ev("cpu_op", "autograd::engine::evaluate_function: EinsumBackward0", 310, 50, BWD),
        ev("cpu_op", "EinsumBackward0", 312, 46, BWD),
        launch(320, 4, BWD),
        flow("s", 40, MAIN),
        flow("f", 312, BWD),
        span("circuit.backward", 400, 250, BWD),
        launch(410, 5, BWD),
        ev("cpu_op", "autograd::engine::evaluate_function: MulBackward0", 660, 30, BWD),
        launch(670, 8, BWD),
        kernel("fold_k", 100, 50, 1),
        kernel("circuit_fwd_k", 150, 250, 2),
        kernel("mul_k", 400, 20, 3),
        kernel("fold_bwd_k", 420, 40, 4),
        kernel("circuit_bwd_k", 460, 140, 5),
        kernel("mul_bwd_k", 690, 10, 8),
        kernel("tail_k", 950, 10, 7),
    ]}


def close(a, b):
    return abs(a - b) < 1e-9


def test_device_time_by_span():
    t = reduce_spans(trace()).table
    # The innermost span on the launching thread.
    assert close(t["circuit.forward"].self_device_ms, 0.250)
    assert close(t["engine.loss"].self_device_ms, 0.020)
    assert close(t["circuit.backward"].self_device_ms, 0.140)
    # Autograd's thread with no span open: the forward's span by the flow...
    assert close(t["born.fold"].self_device_ms, 0.050 + 0.040)
    assert t["born.fold"].launches == 2
    # ... or, with no flow, the main thread's innermost span.
    assert close(t["engine.backward"].self_device_ms, 0.010)
    assert close(t[NO_SPAN].self_device_ms, 0.010)
    # Nested spans add up, across threads too.
    assert close(t["engine.loss"].device_ms, 0.050 + 0.250 + 0.020 + 0.040)
    assert close(t["engine.backward"].device_ms, 0.140 + 0.010)
    assert close(t["engine.epoch"].device_ms, 0.510)
    kernels = reduce_spans(trace()).kernels_by_span
    assert [k for k, _ in kernels["born.fold"]] == ["fold_k", "fold_bwd_k"]


def test_host_time_less_synchronisation():
    t = reduce_spans(trace()).table
    assert t["engine.epoch"].calls == 1
    assert close(t["engine.epoch"].host_ms, 0.890 - 0.080)
    assert close(t["engine.sync"].host_ms, 0.090 - 0.080)
    assert close(t["circuit.backward"].host_ms, 0.250)
    # The fold's backward node (its evaluate_function event), once.
    assert close(t["born.fold"].backward_host_ms, 0.050)
    assert close(t["circuit.forward"].backward_host_ms, 0.0)


def test_idle_gaps_by_span():
    # Busy [100, 600), [690, 700), [950, 960): gaps [700, 950) during the
    # main thread's backward; [0, 100), open at 0 is none, the first to
    # open in it engine.posterior; [600, 690) while autograd's thread is in
    # the later-started circuit.backward; [960, 1000] in no span.
    idle = reduce_spans(trace()).idle_by_span
    assert [k for k, _ in idle] == ["engine.backward", "engine.posterior", "circuit.backward",
                                    NO_SPAN]
    assert [round(s * 1e6) for _, s in idle] == [250, 100, 90, 40]


def test_host_time_less_waits_in_a_full_launch_queue():
    # Eight launches of 2 µs and two that wait for a slot (30 and 12 µs):
    # the time beyond the lower-quartile launch is waiting, not host work.
    durs = [2] * 8 + [30, 12]
    events = [span(WINDOW, 0, 1000), span("engine.epoch", 10, 500),
              span("born.fold", 20, 100)]
    events += [ev("cuda_runtime", "cudaLaunchKernel", 30 + 40 * i, d, correlation=i)
               for i, d in enumerate(durs)]
    s = reduce_spans({"traceEvents": events})
    assert close(s.table["engine.epoch"].host_ms, 0.500 - 0.028 - 0.010)
    assert close(s.table["born.fold"].host_ms, 0.100)
    assert close(s.queue_wait_ms, 0.038) and s.sync_ms == 0.0
    # A synchronising call is waiting as a whole.
    events.append(ev("cuda_runtime", "cudaDeviceSynchronize", 480, 20))
    s = reduce_spans({"traceEvents": events})
    assert close(s.table["engine.epoch"].host_ms, 0.500 - 0.038 - 0.020)
    assert close(s.sync_ms, 0.020)


def test_blocking_calls():
    assert blocked("cudaStreamSynchronize") and blocked("cudaMemcpy")
    assert not blocked("cudaMemcpyAsync") and not blocked("cudaLaunchKernel")


def test_queueing_calls():
    assert queued("cudaLaunchKernel") and queued("cuLaunchKernelEx")
    assert queued("cudaMemcpyAsync") and queued("cudaEventRecord")
    assert not queued("cudaStreamSynchronize") and not queued("cudaMalloc")


def test_no_window_raises():
    with pytest.raises(ValueError):
        reduce_spans({"traceEvents": [span("engine.epoch", 0, 10)]})


@pytest.mark.parametrize("epochs, ok", [(1, True), (3, False)])
def test_checked_wants_one_epoch_span_per_epoch(epochs, ok):
    """The hand-made window holds one engine.epoch span."""
    spans = reduce_spans(trace())
    assert (checked(spans, epochs) is spans) == ok


@pytest.mark.parametrize("spans", [None, Spans(table={})])
def test_checked_without_spans(spans):
    assert checked(spans, 1) is None
