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


def _cfg():
    import json
    from gpubench import harness
    return json.loads((harness.HERE / "configs" / "lj_mol.json").read_text())
