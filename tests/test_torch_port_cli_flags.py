"""The port's CLIs against the JAX package's flag surface and seeding, on
the CPU.

- ``cli/gen_tacotron.py wavernn`` takes ``--pallas`` / ``--no_pallas`` as
  the JAX CLI does (``wavernn_tpu/cli/gen_tacotron.py:39-43``) and ignores
  them: the device picks the engine.
- The hparams' ``random_seed`` (``configs/lj_af_offline.py``: 16) is read
  into the port's ``Config``, and ``cli/train_tacotron.py`` trains with it
  as the JAX CLI does (``wavernn_tpu/cli/train_tacotron.py:40-43``): the
  first epoch's batches come in the JAX ``TTSBatcher``'s order for that
  seed, exactly.
"""
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch_threads  # noqa: F401  the CPU-thread budget

from wavernn_tpu.config import Config as JConfig
from wavernn_tpu.data.dataset import get_tts_datasets as j_datasets
from wavernn_tpu_torch.cli import gen_tacotron, train_tacotron
from wavernn_tpu_torch.config import Config

ROOT = Path(__file__).resolve().parents[1]


class _Parsed(Exception):
    pass


@pytest.mark.parametrize("argv", [
    ["wavernn", "--pallas"],
    ["wavernn", "--no_pallas"],
    ["--input_text", "Hello there.", "--hp_file", "hp.py", "wavernn",
     "--batched", "--target", "11000", "--overlap", "550", "--pallas"],
    ["-i", "Hello.", "wavernn", "-u", "--no_pallas", "--fast"],
])
def test_gen_tacotron_takes_the_pallas_flags(monkeypatch, argv):
    seen = {}

    def stop(hp_file):
        seen["hp_file"] = hp_file
        raise _Parsed

    # everything after the parse is cut off where the config is read
    monkeypatch.setattr(gen_tacotron, "load_config", stop)
    with pytest.raises(_Parsed):
        gen_tacotron.main(argv)
    assert "hp_file" in seen


def test_config_reads_random_seed():
    assert Config.from_hparams_file(
        ROOT / "configs" / "lj_af_offline.py").random_seed == 16
    assert Config().random_seed is None


def _tts_dataset(root, n_items=24, seed=0):
    rng = np.random.RandomState(seed)
    (root / "mel").mkdir(parents=True)
    ids, text = [], {}
    for i in range(n_items):
        name = f"item{i:03d}"
        frames = int(rng.randint(12, 40))
        np.save(root / "mel" / f"{name}.npy",
                rng.uniform(0, 1, (80, frames)).astype(np.float32))
        ids.append((name, frames))
        text[name] = "the birch canoe slid on the smooth planks"[:8 + i]
    with open(root / "dataset.pkl", "wb") as f:
        pickle.dump(ids, f)
    with open(root / "text_dict.pkl", "wb") as f:
        pickle.dump(text, f)


@pytest.mark.parametrize("hp_seed", [16, None])
def test_train_tacotron_batches_in_the_seeds_order(tmp_path, monkeypatch,
                                                   hp_seed):
    data = tmp_path / "data"
    _tts_dataset(data)
    hp = tmp_path / "hp.py"
    hp.write_text("\n".join([
        f"data_path = {str(data)!r}", "tts_model_id = 'seeded'",
        "tts_embed_dims = 32", "tts_postnet_dims = 32", "tts_encoder_K = 2",
        "tts_postnet_K = 2", "tts_num_highways = 1",
        "tts_schedule = [(2, 1e-3, 2, 4)]",
        *([f"random_seed = {hp_seed}"] if hp_seed is not None else [])])
        + "\n")
    got = {}

    def capture(cfg, ws, state, make_dataset, **kw):
        got["batcher"] = make_dataset(2, 4)

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(train_tacotron.tt, "train_loop", capture)
    train_tacotron.main(["--hp_file", str(hp), "--force_cpu", "--seed", "3"])
    port_ids = [list(b[2]) for b in got["batcher"]]
    jcfg = JConfig.from_hparams_file(hp)
    # the hparams' seed when set, else --seed
    seed = 3 if hp_seed is None else hp_seed
    assert (jcfg.random_seed or 3) == seed
    jax_ids = [list(b[2]) for b in j_datasets(data, 4, 2, jcfg, seed=seed)[0]]
    assert len(port_ids) == 6 and port_ids == jax_ids
