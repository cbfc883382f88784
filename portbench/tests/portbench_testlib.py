"""Helpers of the benchmark's tests: the paths and a tiny cell."""
import json
import os
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "portbench"
for p in (str(BENCH), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

torch.set_num_threads(min(2, torch.get_num_threads()))

#: a cell's limits at the tiny sizes (the real cells' numbers): above the
#: largest the port reads against the reference there over 13 seeds (loss
#: 1.7e-7 to 2.5e-7, update norms 3.7e-6 to 7.1e-6, median leaves 6e-8 to
#: 1.3e-6), below the smallest the TF32 control reads over 3 (7.7e-6 to
#: 1.6e-4)
TINY_LIMITS = {"loss_first": 1e-6, "unorm_first": 2e-5, "loss_gap": 2e-6,
               "unorm_gap": 2e-5, "change_med": 5e-6, "update_med": 2e-5,
               "cache_med": 5e-6}


_INIT = [{"match": "embed\\.embedding", "normal": "fan_in"},
         {"match": ".*(ln1|ln2|final_norm|q_norm|k_norm|mamba\\.norm"
                   "|mamba\\.conv_b)",
          "const": 0.0},
         {"match": ".*mamba\\.conv_w", "normal": 0.1},
         {"match": ".*mamba\\.A_log", "log_linspace": [1.0, 16.0]},
         {"match": ".*mamba\\.D", "const": 1.0},
         {"match": ".*mamba\\.dt_bias", "const": -4.6},
         {"match": "unembed|.*\\.(in_proj|out_proj|attn\\.w.*|ffn\\.w.*)",
          "normal": "fan_in"}]

#: tiny configurations of each layer kind the plain reference has (and of
#: q/k norms), with the repository's embedding scale, over the keys of the
#: benchmark's Mamba-2 file
TINY = {
    "attn": dict(family="dense", num_layers=1, num_heads=4, num_kv_heads=2,
                 head_dim=16, d_ff=128, stages=[[["attn"], 1]]),
    "hybrid": dict(family="hybrid", num_layers=4, num_heads=4,
                   num_kv_heads=4, head_dim=16, d_ff=128, window_size=4096,
                   ssm_state=8, ssm_head_dim=16, ssm_chunk=16,
                   stages=[[["mamba", "mamba", "shared_attn"], 1],
                           [["mamba"], 1]]),
    "qk": dict(family="dense", num_layers=2, num_heads=4, num_kv_heads=2,
               head_dim=16, d_ff=128, qk_norm=True, rope_theta=1e6,
               stages=[[["attn"], 2]]),
    "ssm": dict(num_layers=2, ssm_state=8, ssm_head_dim=16, ssm_chunk=16,
                stages=[[["mamba"], 2]]),
}


def tiny_config(kind: str) -> dict:
    cfg = json.loads((BENCH / "configs/mamba2-780m.json").read_text())
    for k in ("expect", "published", "assumed", "deployment", "reduced"):
        cfg.pop(k, None)
    cfg.update(name="tiny", d_model=64, vocab_size=256, init=_INIT,
               **TINY[kind])
    return cfg


def make_tiny_root(tmp: Path, kind: str = "attn", **overrides) -> Path:
    """A checkout of one tiny cell: a tiny configuration of `kind` (with
    `overrides`), the real mix at tiny sizes, its limits, and the
    repository's ``src``."""
    for sub in ("configs", "mixes", "limits"):
        (tmp / "portbench" / sub).mkdir(parents=True, exist_ok=True)
    if not (tmp / "src").exists():
        os.symlink(REPO / "src", tmp / "src")
    cfg = {**tiny_config(kind), **overrides}
    (tmp / "portbench/configs/tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((BENCH / "mixes/ace-int8-k1.b8.json").read_text())
    mix.update(n_clients=4, batch=2, seq=32, n_tokens=4096,
               events_per_call=6)
    (tmp / "portbench/mixes/tiny.json").write_text(json.dumps(mix))
    (tmp / "portbench/limits/tiny.cell.json").write_text(
        json.dumps({"limits": TINY_LIMITS}))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "test",
                         "file": "portbench/configs/tiny.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": "tiny.cell", "config": "tiny",
                           "traffic": "tiny", "chips": 1, "why": "test"}]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
