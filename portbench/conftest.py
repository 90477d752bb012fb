"""Fixtures of the benchmark's CPU tests: a checkout-shaped directory whose
BENCHMARK.json names tiny copies of the two configurations (every width
cut, the same structure) under the real traffic kinds, so that a whole run
fits a CPU test."""

import copy
import json
import sys
from pathlib import Path

import pytest

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent
if str(ROOT / "src") not in sys.path:  # the port, as run.py finds it
    sys.path.insert(0, str(ROOT / "src"))

SMOKE = {"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
         "head_dim": 16, "intermediate_size": 128}


def smoke_config(name):
    """The configuration at smoke widths, its init scaled so that each
    matrix multiplies as the full model's does (std x sqrt(width) kept)."""
    cfg = json.loads((PACKAGE / "configs" / f"{name}.json").read_text())
    std = cfg["assumed"]["init_std"] * (cfg["hidden_size"] / SMOKE["hidden_size"]) ** 0.5
    cfg.update(SMOKE, name=name + "-smoke", assumed=dict(cfg["assumed"], init_std=std),
               num_key_value_heads=cfg["num_key_value_heads"] * 4 // cfg["num_attention_heads"])
    if "embedding_size" in cfg:
        cfg.update(vocab_size=250, embedding_size=256)
    else:
        cfg.update(vocab_size=250)
    return cfg


SMOKE_TRAFFIC = {
    "train-4k": {"seq_len": 64, "prefetch": 2, "traced_steps": 2,
                 "documents": {"mean_len": 21, "max_len": 256}},
    "prefill-short": {"batch": 4, "cache_tokens_per_request": 64, "arrival_rate": 4000.0,
                      "arrival_burst": 4, "cycle_batches": 2,
                      "traced_seconds": 0.05,
                      "prompt_lengths": [12, 40, 64, 20, 33, 50, 8, 64]},
    "prefill-short-tail": {"batch": 4, "cache_tokens_per_request": 64, "arrival_rate": 1000.0,
                           "traced_seconds": 0.05,
                           "prompt_lengths": [12, 40, 64, 20, 33, 50, 8, 64]},
    "prefill-long": {"batch": 1, "cache_tokens_per_request": 96, "arrival_rate": 100.0,
                     "traced_seconds": 0.05, "prompt_lengths": [16, 24, 32, 48, 64, 80, 96, 96]},
}


def write_root(tmp: Path, extra_workloads=()):
    """A directory laid out as a checkout: the real BENCHMARK.json with its
    configurations cut to smoke size and its traffic shortened, plus
    ``extra_workloads``."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"] += list(extra_workloads)
    for sub in ("configs", "traffic", "limits"):
        (tmp / "portbench" / sub).mkdir(parents=True, exist_ok=True)
    for c in spec["configs"]:
        (tmp / c["file"]).write_text(json.dumps(smoke_config(c["name"])))
    for name, cut in SMOKE_TRAFFIC.items():
        tr = json.loads((PACKAGE / "traffic" / f"{name}.json").read_text())
        for k, v in cut.items():
            tr[k] = dict(tr[k], **v) if isinstance(v, dict) else v
        (tmp / "portbench" / "traffic" / f"{name}.json").write_text(json.dumps(tr))
    for f in (PACKAGE / "limits").iterdir():
        (tmp / "portbench" / "limits" / f.name).write_text(f.read_text())
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp, copy.deepcopy(spec)


@pytest.fixture
def smoke_root(tmp_path):
    return write_root(tmp_path)[0]
