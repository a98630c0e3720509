"""The trace's reduction on a synthetic trace: busy is the union of the
device's activity, the harness's ranges are no device time, host waits
and idle gaps come from the stepping thread alone."""

from kbench.trace_reader import Event, reduce

MS = 1_000_000


def test_reduce_on_a_synthetic_trace():
    events = [
        Event("kbench.span", 0, 10 * MS, False, 1, True),
        Event("kbench.span", 0, 10 * MS, True, 0, True),  # the range drawn on the device's row
        Event("kernel_a", 0, 2 * MS, True, 0, False),
        Event("kernel_b", 1 * MS, 2 * MS, True, 0, False),  # overlaps a: busy counts it once
        Event("kernel_a", 6 * MS, 1 * MS, True, 0, False),
        Event("cudaGraphLaunch", 3 * MS, 2 * MS, False, 1, False),
        Event("cudaStreamSynchronize", 7 * MS, 3 * MS, False, 1, False),
        Event("cudaStreamSynchronize", 2 * MS, 5 * MS, False, 2, False),  # the feeder's thread
    ]
    out = reduce(events, 0.01)
    assert out["busy_s"] == 4 * MS / 1e9
    assert out["device_events"] == 3
    assert out["kernels"]["kernel_a"] == (2, 3 * MS / 1e9)
    assert out["host_wait_s"] == 3 * MS / 1e9
    assert out["breakdown"]["idle_gaps"] == [["cudaGraphLaunch", 3 * MS / 1e9]]
    assert out["breakdown"]["device_ops"][0] == ["kernel_a", 3 * MS / 1e9]
