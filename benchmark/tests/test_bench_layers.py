"""The per-layer tool over the port's spans and counters
(``benchmark/layers.py``): nothing without a card, and each number of its
summary from one measurement."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import layers  # noqa: E402

FAKE = {"spans": {"program.warm_up": {"count": 1, "total_s": 0.42,
                                      "max_s": 0.42}},
        "layers": {"layers_ms": {"rng": 7.5, "bsdf": 2.0, "emitter": 0.5},
                   "twin_ms": 15.0, "nodes": 4291, "call_ms": 0.8},
        "samples_per_replay": 524288}


def test_no_measurement_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert layers.main(["cbox_direct.forward", "5"]) == 3


def test_no_measurement_without_a_cell():
    assert layers.main([]) == 2


@pytest.mark.parametrize("name,value", [
    ("rng_share", 50.0), ("bsdf_share", 100 * 2.0 / 15.0),
    ("emitter_share", 100 * 0.5 / 15.0),
    ("graph_nodes_per_msample", 4291 / 0.524288), ("launch_ms", 0.8),
    ("warm_up_s", 0.42)])
def test_summary_reads_one_measurement(name, value):
    assert layers.summary(FAKE)[name] == pytest.approx(value)


def test_summary_without_a_warm_up_span():
    assert layers.summary({**FAKE, "spans": {}})["warm_up_s"] is None
