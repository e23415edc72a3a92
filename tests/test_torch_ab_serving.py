"""``zookeeper_tpu_torch.ab_serving``: a leg at a tiny size on the CPU
(its own process, the checkout's root first on ``sys.path``) and the
summary's arithmetic."""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import json
import pathlib
import subprocess
import sys

from zookeeper_tpu_torch import ab_serving as ab

ROOT = pathlib.Path(__file__).resolve().parents[1]

LM = {**ab.LM, "device": "cpu", "model.num_layers": 1, "model.d_model": 16,
      "model.num_heads": 2, "model.compute_dtype": "float32", "seq_len": 64,
      "vocab_size": 61, "requests": 4, "max_prompt": 12, "new_tokens": 4,
      "engine.seq_buckets": (16,), "engine.page_size": 4}
CNN = {**ab.CNN, "device": "cpu", "model": "QuickNet", "model.compute_dtype": "float32",
       "model.blocks_per_section": (1, 1, 1, 1), "model.section_features": (8, 8, 16, 16),
       "height": 16, "width": 16, "num_classes": 10, "requests": 4}


def test_a_leg_serves_both_paths_and_hashes_equal_answers(tmp_path):
    spec = json.dumps({"lm": LM, "cnn": CNN, "runs": 2})
    proc = subprocess.run(
        [sys.executable, str(ROOT / "zookeeper_tpu_torch" / "ab_serving.py"), "--leg",
         str(ROOT), spec],
        cwd=tmp_path, capture_output=True, text=True, timeout=300, check=True)
    leg = json.loads(proc.stdout.strip().splitlines()[-1])
    assert pathlib.Path(leg["root"]) == ROOT
    assert len(leg["lm"]) == len(leg["cnn"]) == len(leg["forward_ms"]) == 2
    assert all(set(run) == set(ab.LM_KEYS) for run in leg["lm"])
    assert all(set(run) == set(ab.CNN_KEYS) for run in leg["cnn"])
    assert all(run["tokens_per_sec"] > 0 for run in leg["lm"])
    assert all(ms > 0 for ms in leg["forward_ms"])
    assert leg["forward_ops"] > 0 and leg["forward_kernels"] == 0  # no card here
    assert leg["decode_ops"] > 0 and leg["decode_kernels"] == 0
    assert len(leg["decode_step_ms"]) == ab.DECODE_REPS
    assert all(ms > 0 for ms in leg["decode_step_ms"])
    # Three runs of each path (one unmeasured) give one answer each.
    assert len(leg["lm_tokens"]) == 1 and len(leg["cnn_logits"]) == 1


def _leg(tokens_per_sec, forward_ms):
    return {"lm": [{k: tokens_per_sec if k == "tokens_per_sec" else 1.0 for k in ab.LM_KEYS}],
            "cnn": [dict.fromkeys(ab.CNN_KEYS, 2.0)], "forward_ms": [forward_ms],
            "decode_step_ms": [3.0]}


def test_summary_medians_ratio_and_overlap():
    legs = [("other", _leg(100.0, 10.0)), ("change", _leg(90.0, 10.5)),
            ("change", _leg(95.0, 9.5)), ("other", _leg(110.0, 10.0))]
    out = ab._summary(legs, "change", "other")
    tps = out["lm.tokens_per_sec"]
    assert tps["change"] == [90.0, 95.0] and tps["other"] == [100.0, 110.0]
    assert tps["median_change"] == 92.5 and tps["median_other"] == 105.0
    assert tps["change_over_other"] == 92.5 / 105.0
    assert tps["ranges_overlap"] is False
    assert out["cnn.forward_ms"]["ranges_overlap"] is True
    assert out["cnn.qps"]["change_over_other"] == 1.0
