"""Serving launcher of the PyTorch port: the continuous-batching engine over
seeded random weights or a reference checkpoint.

Closed-loop (default): submit --requests up front, drain synchronously —
a throughput run.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama_1_1b \\
        --requests 16 --max-batch 8 --max-seq 2048 [--ckpt artifacts/train]

Open-loop: Poisson arrivals at --rate req/s against the engine running
on its background thread — the latency-under-load run.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama_1_1b \\
        --smoke --device cpu --mode open --rate 4 --requests 32

--device defaults to cuda; without CUDA the launcher raises rather than
fall back (pass --device cpu to run the plain versions on the CPU).
The paged pool (--max-cache-pages) and the fleet collector
(--xfa-collector) are not ported yet and raise NotImplementedError.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs import get_config, get_smoke
from ..configs.base import ServeConfig
from ..models import build_model, load_reference_checkpoint, params_from_numpy
from ..serving import ServingEngine, latency_stats, run_workload


def summarize(done, wall_s: float) -> str:
    s = latency_stats(done, wall_s)
    lines = [f"served {s['requests']:.0f} requests / {s['tokens']:.0f} "
             f"tokens in {s['wall_s']:.2f}s "
             f"({s['throughput_tok_s']:.1f} tok/s)"]
    if "ttft_mean_s" in s:
        lines.append(f"ttft       mean {s['ttft_mean_s'] * 1e3:.1f}ms  "
                     f"p50 {s['ttft_p50_s'] * 1e3:.1f}ms  "
                     f"p95 {s['ttft_p95_s'] * 1e3:.1f}ms")
    if "queue_wait_mean_s" in s:
        lines.append(f"queue_wait mean {s['queue_wait_mean_s'] * 1e3:.1f}ms  "
                     f"p95 {s['queue_wait_p95_s'] * 1e3:.1f}ms")
    if s["truncated"]:
        lines.append(f"truncated prompts: {s['truncated']:.0f}")
    return "\n".join(lines)


def load_params(model, ckpt: str):
    """Params from a reference checkpoint: a bare params tree or a train
    state whose params sit under 'params/'."""
    flat = load_reference_checkpoint(ckpt)
    if any(k.startswith("params/") for k in flat):
        flat = {k[len("params/"):]: v for k, v in flat.items()
                if k.startswith("params/")}
    return params_from_numpy(flat, model.cfg, model.device)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--ckpt", default="",
                    help="reference checkpoint dir (repro.ckpt layout)")
    ap.add_argument("--seed", type=int, default=0,
                    help="random-weight seed when no --ckpt is given")
    # -- workload ------------------------------------------------------------
    ap.add_argument("--mode", choices=("closed", "open"), default="closed",
                    help="closed: submit all then drain (throughput); open: "
                         "Poisson arrivals on a live engine (latency)")
    ap.add_argument("--rate", type=float, default=4.0,
                    help="open-loop mean arrival rate, requests/s")
    # -- scheduler -----------------------------------------------------------
    ap.add_argument("--prefill-chunk", type=int, default=512,
                    help="tokens per in-model prefill chunk")
    ap.add_argument("--tail-chunk", type=int, default=0,
                    help="continuation-chunk width (0: same as "
                         "--prefill-chunk)")
    ap.add_argument("--prefill-budget", type=int, default=0,
                    help="per-tick prefill token budget (0: unbounded)")
    ap.add_argument("--no-bucket-chunks", action="store_true",
                    help="disable power-of-two chunk-width bucketing")
    ap.add_argument("--min-chunk-bucket", type=int, default=8,
                    help="smallest power-of-two chunk bucket")
    ap.add_argument("--prefill-batch", type=int, default=8,
                    help="max slots whose same-width prefill chunks batch "
                         "into ONE forward_chunk call per tick")
    ap.add_argument("--max-cache-pages", type=int, default=0,
                    help="paged KV-cache pool (not ported yet: > 0 raises)")
    ap.add_argument("--page-size", type=int, default=64)
    # -- sampling ------------------------------------------------------------
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--sample-seed", type=int, default=0)
    # -- profiling -----------------------------------------------------------
    ap.add_argument("--profile-dir", default="",
                    help="write this replica's XFA profile shard here "
                         "(reduce with: python -m repro.profile report DIR)")
    ap.add_argument("--profile-interval", type=int, default=256,
                    help="decode ticks between shard refreshes")
    ap.add_argument("--profile-label", default="serve")
    ap.add_argument("--profile-keep-last", type=int, default=8)
    ap.add_argument("--profile-max-age-s", type=float, default=0.0)
    ap.add_argument("--profile-max-bytes", type=int, default=0)
    from ..profile import kv_pair
    ap.add_argument("--profile-meta", action="append", default=[],
                    type=kv_pair, metavar="KEY=VALUE",
                    help="extra run-manifest metadata (repeatable)")
    ap.add_argument("--xfa-collector", default="", metavar="HOST:PORT",
                    help="fleet collector stream (not ported yet)")
    ap.add_argument("--xfa-host-label", default="",
                    help="override this replica's host label in shard "
                         "names and manifests (default: hostname)")
    ap.add_argument("--xfa-budget-pct", type=float, default=0.0,
                    help="host-tracer overhead budget as a percent of wall "
                         "time (0: governor off)")
    args = ap.parse_args()

    if args.xfa_host_label:
        from ..profile import set_host_label
        set_host_label(args.xfa_host_label)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, impl="auto", device=args.device)
    params = load_params(model, args.ckpt) if args.ckpt \
        else model.init(args.seed)

    engine = ServingEngine(model, params, ServeConfig(
        max_batch=args.max_batch, max_seq_len=args.max_seq,
        prefill_chunk=args.prefill_chunk,
        tail_chunk=args.tail_chunk,
        prefill_budget_tokens=args.prefill_budget,
        bucket_chunks=not args.no_bucket_chunks,
        min_chunk_bucket=args.min_chunk_bucket,
        prefill_batch=args.prefill_batch,
        page_size=args.page_size,
        max_cache_pages=args.max_cache_pages,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        sample_seed=args.sample_seed,
        profile_dir=args.profile_dir,
        profile_interval_ticks=args.profile_interval,
        profile_label=args.profile_label,
        profile_keep_last=args.profile_keep_last,
        profile_max_age_s=args.profile_max_age_s,
        profile_max_bytes=args.profile_max_bytes,
        profile_meta=tuple(args.profile_meta),
        xfa_collector=args.xfa_collector,
        xfa_overhead_budget=args.xfa_budget_pct / 100.0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab,
                            int(rng.integers(4, args.max_seq // 4)))
               for _ in range(args.requests)]
    t0 = time.monotonic()
    done = run_workload(engine, prompts, args.max_new, mode=args.mode,
                        rate=args.rate, rng=rng)
    print(summarize(done, time.monotonic() - t0))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
