"""A cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds, for
the tests that drive a whole run of the harness on the CPU: widths, depth,
vocabulary, lengths and rates shrunk, every other setting the cell's."""

import copy

from perfbench import bench

TINY = {"hidden_size": 512, "intermediate_size": 1024, "num_hidden_layers": 4,
        "num_attention_heads": 8, "num_key_value_heads": 2,
        "vocab_size": 8192}


#: the paced cell PERF.md §7 keeps out of BENCHMARK.json (host paced),
#: with its metrics, so the tests still drive the open loop, the deadlines
#: and its readers; it comes back by adding these entries
PACED = {
    "workload": {"name": "smollm.docqa.paced", "config": "smollm-360m",
                 "traffic": "docqa", "chips": 1,
                 "why": "open loop Poisson, prompts 256-2048, deadlines"},
    "end_to_end": [
        {"name": "latency_p90_ms", "unit": "ms", "better": "lower",
         "bound": 0.25, "source": "host_clock",
         "workloads": ["smollm.docqa.paced"]},
        {"name": "on_time_share", "unit": "%", "better": "higher",
         "bound": 0.25, "source": "host_clock",
         "workloads": ["smollm.docqa.paced"]}],
    "per_layer": [
        {"name": n, "unit": u, "better": "lower", "source": src,
         "layer": layer, "moves": moves, "workloads": ["smollm.docqa.paced"]}
        for n, u, src, layer, moves in (
            ("latency_p50_ms", "ms", "host_clock", "front door",
             "latency_p90_ms"),
            ("sched_ms_per_req", "ms", "program_counter", "control plane",
             "latency_p90_ms"),
            ("dropped_share", "%", "program_counter", "control plane",
             "on_time_share"))]}


#: the backlog cells PERF.md §7 keeps out of BENCHMARK.json (their rates
#: spread past any bound: yi-9b's over a window's ~25 answers, the shared
#: documents' from run to run on the host), with the configuration only
#: they use; each reports what ``LIKE`` reports, and comes back by adding
#: these entries
KEPT_OUT = [
    {"name": "yi9b.longdoc.backlog", "config": "yi-9b", "traffic": "longdoc",
     "chips": 1, "why": "closed loop, 32 clients, unique long prompts"},
    {"name": "smollm.shared_docs.backlog", "config": "smollm-360m",
     "traffic": "shared_docs", "chips": 1,
     "why": "closed loop, 64 clients, questions about 8 shared documents"}]
YI_CONFIG = {"name": "yi-9b", "source": "https://huggingface.co/01-ai/Yi-9B",
             "file": "perfbench/configs/yi-9b.json",
             "reduced": ["max_position_embeddings", "rms_norm_eps"],
             "why": "dense GQA 32/4 at published widths"}
LIKE = "smollm.longdoc.backlog"


def benchmark() -> dict:
    """BENCHMARK.json with the kept-out cells' entries added."""
    b = bench.load_json(bench.ROOT / "BENCHMARK.json")
    b["workloads"] += [PACED["workload"]] + KEPT_OUT
    b["configs"].append(YI_CONFIG)
    b["end_to_end"] += PACED["end_to_end"]
    b["per_layer"] += PACED["per_layer"]
    for m in b["end_to_end"] + b["per_layer"]:
        if LIKE in m.get("workloads", ()):
            m["workloads"] += [w["name"] for w in KEPT_OUT]
    return b


def tiny_cell(name: str):
    cell = bench.Cell(benchmark(), name)
    conf = dict(cell.conf, **TINY)
    cell.settings = copy.deepcopy(cell.settings)
    cell.settings["engine"].update(max_batch=4, step_token_budget=64,
                                   max_len=256, prefix_max_prompt=256,
                                   kv_cache_blocks=256)
    cell.settings["clients"] = min(cell.settings.get("clients", 0), 8)
    cell.settings["ramp_s"] = 0.5
    mix = copy.deepcopy(cell.mix)
    # prompts a 32nd, answers a quarter of the mix's: a sample still
    # holds a couple of hundred served tokens
    for k, cut in (("prompt", 32), ("output", 4)):
        for f in ("min", "max", "median"):
            if f in mix[k]:
                mix[k][f] = max(2 if f == "min" else 4, mix[k][f] // cut)
    if "documents" in mix:
        mix["documents"].update(min=64, max=128)
        mix["prompt"].update(min=4, max=16)
    if "rate_per_s" in mix:
        mix["rate_per_s"] = 6.0
    cell.mix = mix
    return cell, conf
