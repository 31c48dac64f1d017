"""Reading a traced window from synthetic events: busy time, device time by
kernel name, idle gaps labelled by what the host was doing."""

import pytest

from perfbench.harness.trace import Event, kernel_seconds, kernels, read


def _events():
    return [
        Event("bench.round", 0.0, 1.0, False),
        Event("bench.round", 1.0, 2.0, False),
        Event("bench.cohort", 0.1, 0.9, False),
        Event("aten::mm", 0.1, 0.2, False),
        Event("aten::item", 1.2, 1.6, False),
        Event("void fedavg_vec16<float>(float const*, float const*, float*, long, long)",
              0.1, 0.5, True),
        Event("gemm", 0.4, 0.8, True),
        Event("void rmsnorm_rows_reg<float, 8>(float const*, float const*, float*, long, int, "
              "float)", 1.0, 1.1, True),
        Event("gemm", 1.7, 2.5, True),
    ]


def test_busy_and_ops():
    r = read(_events())
    assert r.window_s == pytest.approx(2.0)
    # [0.1, 0.8] + [1.0, 1.1] + [1.7, 2.0] inside the window
    assert r.busy_s == pytest.approx(0.7 + 0.1 + 0.3)
    assert r.device_ops["gemm"] == pytest.approx(0.4 + 0.3)


def test_gaps_longest_first_with_labels():
    r = read(_events())
    (label, seconds), *rest = r.idle_gaps
    assert seconds == pytest.approx(0.6) and label == "round: aten::item"
    assert [s for _, s in rest] == pytest.approx([0.2, 0.1])


def test_kernel_seconds():
    evs = _events() + [Event("_Z12fedavg_vec16IfEvPKT_PKfPS0_ll", 1.2, 1.3, True)]
    assert kernel_seconds(evs, "fedavg_") == pytest.approx(0.5)
    assert kernel_seconds(evs, "rmsnorm_rows") == pytest.approx(0.1)
    assert len(kernels(evs, "fedavg_")) == 2


def test_no_device_work_fails():
    with pytest.raises(SystemExit):
        read([Event("bench.round", 0.0, 1.0, False)])
