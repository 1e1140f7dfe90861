"""Dataset metadata recipes (reference utils/text/recipes.py; a copy of
``wavernn_tpu.text.recipes``)."""
from __future__ import annotations

from pathlib import Path
from typing import Dict


def ljspeech(path) -> Dict[str, str]:
    """Read LJSpeech-style ``metadata.csv`` -> {item_id: normalized text}."""
    csv_file = Path(path) / "metadata.csv"
    text_dict: Dict[str, str] = {}
    with open(csv_file, encoding="utf-8") as f:
        for line in f:
            split = line.split("|")
            text_dict[split[0]] = split[-1].strip()
    return text_dict
