"""The frozen work functions against the bounds PERF.md records."""
import pytest

from gpubench import yardstick as Y


def test_b1_main_shape():
    # B1 at 10 folds x 12,100 steps, bf16 weights: 892.1 GFLOP, 0.902 ms
    fl, nb = Y.b1_work(10, 12100, 44, 512, 512, 32, 80, 30, 5, 2)
    assert fl / 1e9 == pytest.approx(892.1, abs=0.05)
    assert Y.least_s(fl, nb, Y.PEAK_BF16) * 1e3 == pytest.approx(0.902,
                                                                 abs=5e-4)


def test_b7_full_shape():
    # B7 at B 32, T_text 150, 200 groups, r 2: 97.36 / 224.70 GFLOP
    d = Y.dims(_cfg())
    (ff, _), (fb, _) = Y.b7_step(d, 32, 150, 400, 2)
    assert ff / 1e9 == pytest.approx(97.36, abs=0.005)
    assert fb / 1e9 == pytest.approx(224.70, abs=0.005)


def test_b1_call_uses_the_configuration():
    d = Y.dims(_cfg())
    assert d["K"] == 5 and d["A"] == 32 and d["NC"] == 30
    assert Y.b1_call(d, 10, 11000, 550) == Y.b1_work(10, 12100, 44, 512,
                                                     512, 32, 80, 30, 5, 2)


@pytest.mark.parametrize("total", [1, 550, 11549, 11550, 12100, 12101,
                                   248050, 23650])
def test_num_folds_covers(total):
    n = Y.num_folds(total, 11000, 550)
    # n folds of 12,100 at a stride of 11,550 cover the samples, n - 1 not
    assert n * 11550 + 550 >= total
    assert n == 1 or (n - 1) * 11550 + 550 < total


def test_shares_stay_under_the_peak():
    d = Y.dims(_cfg())
    # the model FLOPs of one 100-character request, counted at the peak,
    # take less time than any run of it could
    f = Y.tacotron_flops(d, 1, 100, 530, 2) + Y.melresnet_flops(d, 530)
    assert 0 < f / Y.PEAK_F32 < 1e-3
    # a vocoder step's B5 least time, and its three forward passes at the
    # peak, against device times at the kernel table's best (B5 6.22 + 5.75
    # ms a GRU) and the chip's 20.73 steps a second
    from gpubench import readers
    ctx = type("Ctx", (), {
        "cfg": _cfg(), "calls": [{"B": 32, "T": 1375}] * 10,
        "window_s": 10 / 20.73, "busy_s": 10 / 20.73,
        "kernel_s": lambda self, *p: 10 * 2 * (6.22e-3 + 5.75e-3)})()
    assert 0 < readers.b5_voc_roofline(ctx) < 100
    assert 0 < readers.voc_train_mfu(ctx) < 100
    # the model's forward FLOPs: the GRUs and products dominate
    assert 300e9 < Y.wavernn_train_flops(d, 32, 1375) < 400e9


def _cfg():
    import json
    from gpubench import harness
    return json.loads((harness.HERE / "configs" / "lj_mol.json").read_text())


def test_b5_at_the_vocoders_shape():
    # B5 at T 1375, B 32, H 512, f32: 69.2 GFLOP, 1.033 ms each way
    for backward in (False, True):
        fl, nb = Y.gru_work(1375, 32, 512, 4, backward)
        assert fl / 1e9 == pytest.approx(69.2, abs=0.05)
        assert Y.least_s(fl, nb, Y.PEAK_F32) * 1e3 == pytest.approx(
            1.033, abs=5e-4)
    assert Y.b5_voc_step(Y.dims(_cfg()), 32, 1375) == [
        Y.gru_work(1375, 32, 512, 4, b) for b in (False, True, False, True)]



def test_each_device_op_goes_to_the_stage_it_was_launched_in():
    # an op belongs to the first stage mark at or after its launch on the
    # host; one launched after the last mark, or whose launch the trace
    # lacks, to none
    from gpubench import trace
    dev = [(10, 14, "a", 1.0), (15, 19, "b", 2.0), (30, 33, "c", 6.0),
           (40, 41, "d", 12.0), (50, 52, "e", None), (60, 61, "f", 25.0)]
    marks = [(20.0, "forward"), (5.0, "forward"), (9.0, "backward")]
    by, lost = trace.stage_seconds(dev, marks)
    assert by == pytest.approx({"forward": 9e-6, "backward": 3e-6})
    assert lost == pytest.approx(3e-6)
    assert trace.stage_seconds(dev, []) is None


def test_stage_marks_reach_the_trace():
    from torch.profiler import ProfilerActivity, profile
    from gpubench import trace
    t = trace.StageMarks()
    with profile(activities=[ProfilerActivity.CPU]) as p:
        for name in ("forward", "backward", "forward"):
            t.setdefault(name, []).append(name)
    marks = trace._events(p)[2]
    assert [m[1] for m in sorted(marks)] == ["forward", "backward",
                                            "forward"]
    assert t == {"forward": ["forward", "forward"], "backward": ["backward"]}
