#!/usr/bin/env python3
"""Compare two checkouts of the repository on one NVIDIA GPU, in turns.

Run from the root of a checkout, on a machine with one H100 and nvcc,
with the root of a second checkout (for example the parent commit,
unpacked with `git archive` into a directory .gitignore lists):

    python3 chip_ab.py OTHER_ROOT [--phases kernels,groups,serve] [--pairs N]

The phases run in a fresh process per checkout, N pairs of them (default
2), the side that goes first alternating from pair to pair (other, this,
this, other, ...), so that drift of the card and its host shows as a
spread rather than as a difference.  A checkout builds its kernels from
source in its first process.  Phases:

  kernels  the launch floor (an empty kernel, a zero-cycle spin, timed
           as the kernels are); rmsnorm at 8x1x2048, 8x1x2560, 8x512x2048
           and 4x2048x2048 beside F.rms_norm, and rmsnorm_backward at
           4x2048x2048, each also with its kernels' own device time per
           call (torch.profiler, each launch apart), and the host's time
           per ops.rmsnorm call at 8x1x2048 under no_grad; chunk attention (dense, and paged at page sizes
           64 and 16) at the shapes of chip_smoke.py phases 3 and 3c
           (bf16, B 8, S 2048: Hq 32 / Hkv 4 / D 64 and Hq = Hkv = 32 /
           D 80, T 512 and T 8), and at B 1 (row 6 of the batch, dense and
           paged at 64, checked equal to that row in the batch), and
           decode attention (dense, and paged at page size 64) at the
           same two widths and phase 3's kv_len, median of 20 launches
           with the L2 flushed, beside SDPA with a boolean mask; paged
           output checked equal to the dense one; then ssd_scan at
           chip_smoke.py phase 3c's shape (x [B, 512, 80, 64] bf16, N 64,
           chunk 128, h0 f32) at B 8 and B 1, and ssd_scan_backward at
           the training shape (x, dy [4, 2048, 80, 64] bf16, N 64, chunk
           128; without h0, and with h0 and dh_final), each also with its
           kernels' own device time per call, and (where the checkout has
           ssd_bwd_plan) the bf16 backward at every head group a block may
           take, the planner's choice marked: the times its cost model is
           fitted to
  groups   the device time of one full-width prefill group (B 8 x T 512 at
           the phase-3 offsets) for tinyllama_1_1b and zamba2_2_7b, by
           torch.profiler, and the chunk-attention and SSD-scan kernels'
           share of it
  serve    chip_smoke.py's serve runs of the checkout (tinyllama on the
           contiguous and the paged pool, zamba2): tok/s, TTFT p50 / p95,
           the XFA prefill_chunk mean
  mla      MLA's latent attention at chip_smoke.py phase 3e's shapes (bf16,
           B 8, 16 q heads over ckv [8, 2048, 512] and krope [8, 2048, 64],
           sm_scale 192 ** -0.5): decode at phase 3's kv_len, chunk at T 512
           and T 8, dense and paged (page size 64), median of 20 launches
           with the L2 flushed.  A checkout with kernels/mla_attention.py
           runs its latent entry points on the cache in place; one without
           runs the k/v wrappers on k = [ckv | krope] and v = ckv
           zero-padded, built outside the timed call, and also times the
           call with those two copies inside it, as its MLA layer paid.
           Then where a decode's time goes: the launch floor, decode with
           every kv_len 0 (no tile: the block's fixed cost), 1 (one tile a
           row, no merge), 128 (one range of
           two tiles, no merge) and 2048 (16 ranges a row merged in the
           launch), and at phase 3's kv_len; one MLA attention layer of
           deepseek at full width (a prefill chunk [8, 512] and a decode
           tick [8, 1] against an [8, 2048] latent cache): its device time
           a call, its attention kernel's and its copy and fill kernels'
           (torch.profiler); with the latent entry points,
           decode at ranges of 128, 256 and 512 rows and chunk T 8 at a
           target of 8, 16 and 33 blocks a row (the split plans'
           constants, set for the run)
  flash    the flash pair (bf16) at tinyllama's training layout (q
           [4,32,2048,64] over 4 kv heads, causal) and seamless's (q
           [4,16,2048,64] over 16 kv heads, non-causal): the forward,
           training's forward (flash_attention(keep_f32=True), where the
           checkout has it: the forward that also keeps o in f32 for the
           backward) and the backward from that forward's o, median of 20
           launches with the L2 flushed; then the gradients of attention
           on K, Q and V rows that share one large component (as a
           cross-attention's K from an encoder; D 64 G 1, D 128 G 4, D 80
           G 1): the relative L2 of dq, dk and dv from the f64 gradient,
           for the FlashAttention Function, for the backward kernel given
           the forward's o rounded to bf16, and for the plain path in bf16

Prints one `RESULT <tag> ...` line per measurement and the card's name and
power limit.  Exits non-zero if a process fails or there is no GPU.
"""

from __future__ import annotations

import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("kernels", "groups", "serve", "mla", "flash")
POS_T512 = [0, 512, 1024, 1536, 100, 700, 1300, 7]
POS_T8 = [0, 5, 100, 1000, 2040, 333, 1500, 17]
KV_LEN = [0, 1, 77, 1000, 1537, 2047, 2048, 513]   # chip_smoke.py phase 3
HOST_LEAD_CYCLES = 1_000_000   # device spin before a timed call (chip_smoke.py)


def main() -> None:
    args = sys.argv[1:]
    if args and args[0] == "--worker":
        worker(Path(args[1]), args[2], args[3].split(","))
        return
    if not args:
        sys.exit(__doc__)
    other = Path(args[0]).resolve()
    opts = dict(zip(args[1::2], args[2::2]))
    phases = opts.get("--phases", ",".join(PHASES)).split(",")
    pairs = int(opts.get("--pairs", 2))
    if not (other / "chip_smoke.py").exists():
        sys.exit(f"{other} is not a checkout of the repository")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    sides = (("other", other), ("this", ROOT))
    order = [side for i in range(pairs)
             for side in (sides[::-1] if i % 2 else sides)]
    for tag, root in order:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--worker", str(root), tag, ",".join(phases)],
                              cwd=root, capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            if line.startswith("RESULT"):
                print(line, flush=True)
        if proc.returncode != 0:
            sys.exit(f"{tag} ({root}) failed:\n{proc.stderr[-4000:]}")
    print(smi, flush=True)


def worker(root: Path, tag: str, phases) -> None:
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for phase in phases:
        {"kernels": kernels, "groups": groups, "serve": serve,
         "mla": mla, "flash": flash}[phase](torch, tag)


def result(tag: str, msg: str) -> None:
    print(f"RESULT {tag} {msg}", flush=True)


def time_ms(torch, fn, flush, iters: int = 20) -> float:
    """Median device time of one call (CUDA events), L2 flushed and the
    card held busy before (so the host's enqueue time is not timed)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        # keep the card busy while the host enqueues the call, so the
        # events time the device and not the wrapper's host overhead
        torch.cuda._sleep(HOST_LEAD_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def arena(torch, k, ps, perm):
    """The cache k [B, Hkv, S, D] as ps-row pages: row b's page j is arena
    page perm[b, j]; page 0 holds large finite garbage."""
    B, Hkv, S, D = k.shape
    out = torch.full((1 + perm.numel(), Hkv, ps, D), 1e4, dtype=k.dtype,
                     device=k.device)
    out[perm.reshape(-1).long()] = k.reshape(B, Hkv, S // ps, ps, D) \
        .transpose(1, 2).reshape(-1, Hkv, ps, D)
    return out


def dev_us(e) -> float:
    """Device time of a profiler row, in us, across torch versions."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if getattr(e, attr, None):
            return float(getattr(e, attr))
    return 0.0


def norm_kernels(torch, tag: str, flush, gen) -> None:
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as rms

    dev = "cuda"
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev) \
        .to(torch.bfloat16)
    floor = time_ms(torch, lambda: torch.cuda._sleep(0), flush)
    result(tag, f"launch floor (an empty kernel): {floor:.4f} ms")
    for shape in ((8, 1, 2048), (8, 1, 2560), (8, 512, 2048),
                  (4, 2048, 2048)):
        d = shape[-1]
        x = rnd(*shape)
        w = (1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)) \
            .to(torch.bfloat16)
        run = lambda: rms.rmsnorm(x, w)
        lib = lambda: F.rms_norm(x, (d,), w, 1e-5)
        result(tag, f"rmsnorm {'x'.join(map(str, shape))}: "
                    f"{time_ms(torch, run, flush):.4f} ms (kernel "
                    f"{launch_ms(torch, run, flush)}), F.rms_norm "
                    f"{time_ms(torch, lib, flush):.4f} ms")
    host_us(torch, tag)
    x, dy = rnd(4, 2048, 2048), rnd(4, 2048, 2048)
    w = (1.0 + 0.1 * torch.randn(2048, generator=gen, device=dev)) \
        .to(torch.bfloat16)
    run = lambda: rms.rmsnorm_backward(x, w, dy)
    result(tag, f"rmsnorm_backward 4x2048x2048: "
                f"{time_ms(torch, run, flush):.4f} ms; per launch "
                f"{launch_ms(torch, run, flush)}")


def host_us(torch, tag: str, calls: int = 2000) -> None:
    """The host's time per `ops.rmsnorm` call at a decode tick's rows
    (8 x 1 x 2048 bf16) under torch.no_grad, as the serving path calls
    it: the wall time of enqueueing `calls` calls."""
    import time
    from repro_torch.kernels import ops

    x = torch.randn(8, 1, 2048, device="cuda").to(torch.bfloat16)
    w = torch.ones(2048, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        for _ in range(50):
            ops.rmsnorm(x, w)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            ops.rmsnorm(x, w)
        host = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
    result(tag, f"ops.rmsnorm 8x1x2048 under no_grad: host {host:.2f} us "
                f"a call (mean of {calls})")


def launch_ms(torch, fn, flush, what: str = "rmsnorm") -> str:
    """The device time per call of each kernel whose symbol holds `what`:
    torch.profiler over 20 calls, L2 flushed and the card held busy before
    each, as time_ms."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as p:
        for _ in range(20):
            flush.zero_()
            torch.cuda._sleep(HOST_LEAD_CYCLES)
            fn()
        torch.cuda.synchronize()
    symbol = re.compile(re.escape(what) + r"\w*")
    return ", ".join(
        f"{symbol.search(e.key).group(0)} {dev_us(e) / e.count / 1e3:.4f} ms"
        for e in p.key_averages() if what in e.key and dev_us(e) > 0)


def kernels(torch, tag: str) -> None:
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dec

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev) \
        .to(torch.bfloat16)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    norm_kernels(torch, tag, flush, gen)
    B, S = 8, 2048
    for Hq, Hkv, D in ((32, 4, 64), (32, 32, 80)):
        for T, pos_l in ((512, POS_T512), (8, POS_T8)):
            q, k, v = rnd(B, Hq, T, D), rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
            pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
            lim = pos[:, None] + torch.arange(T, device=dev)[None, :]
            mask = (torch.arange(S, device=dev)[None, None, :]
                    <= lim[:, :, None])[:, None]
            dense = lambda: dec.chunk_attention(q, k, v, pos=pos)
            sdpa = lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True)
            o = dense()
            msg = (f"chunk T{T} D{D} G{Hq // Hkv}: dense "
                   f"{time_ms(torch, dense, flush):.4f} ms, sdpa "
                   f"{time_ms(torch, sdpa, flush):.4f} ms")
            for ps in (64, 16):
                perm = (torch.randperm(B * S // ps, generator=gen, device=dev)
                        + 1).to(torch.int32).reshape(B, S // ps)
                kp, vp = arena(torch, k, ps, perm), arena(torch, v, ps, perm)
                bt = perm.clone()
                for b, p in enumerate(pos_l):
                    bt[b, -(-(p + T) // ps):] = 0
                run = lambda: dec.chunk_attention_paged(
                    q, kp, vp, block_table=bt, pos=pos)
                same = torch.equal(run(), o)
                msg += (f", paged ps {ps} {time_ms(torch, run, flush):.4f} "
                        f"ms (equal to dense: {same})")
                if ps == 64:
                    # one row alone (row 6), dense and paged
                    one = slice(6, 7)
                    q1, k1, v1 = (t[one].contiguous() for t in (q, k, v))
                    bt1 = bt[one].contiguous()
                    alone = lambda: dec.chunk_attention(q1, k1, v1,
                                                        pos=pos[one])
                    alone_p = lambda: dec.chunk_attention_paged(
                        q1, kp, vp, block_table=bt1, pos=pos[one])
                    same1 = torch.equal(alone(), o[one]) and \
                        torch.equal(alone_p(), o[one])
                    b1 = (f"; B1 (row 6) dense "
                          f"{time_ms(torch, alone, flush):.4f} ms, paged ps "
                          f"64 {time_ms(torch, alone_p, flush):.4f} ms "
                          f"(equal to the row in the batch: {same1})")
                del kp, vp
            result(tag, msg + b1)
            del q, k, v, o
    for Hq, Hkv, D in ((32, 4, 64), (32, 32, 80)):
        q = rnd(B, Hq, D)
        k, v = rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
        kv_len = torch.tensor(KV_LEN, dtype=torch.int32, device=dev)
        mask = (torch.arange(S, device=dev)[None, :]
                < kv_len[:, None])[:, None, None, :]
        dense = lambda: dec.decode_attention(q, k, v, kv_len=kv_len)
        sdpa = lambda: F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)
        o = dense()
        perm = (torch.randperm(B * S // 64, generator=gen, device=dev)
                + 1).to(torch.int32).reshape(B, S // 64)
        kp, vp = arena(torch, k, 64, perm), arena(torch, v, 64, perm)
        bt = perm.clone()
        for b, n in enumerate(KV_LEN):
            bt[b, -(-n // 64):] = 0
        paged = lambda: dec.decode_attention_paged(q, kp, vp, block_table=bt,
                                                   kv_len=kv_len)
        same = torch.equal(paged(), o)
        result(tag, f"decode D{D} G{Hq // Hkv}: dense "
                    f"{time_ms(torch, dense, flush):.4f} ms, sdpa "
                    f"{time_ms(torch, sdpa, flush):.4f} ms, paged ps 64 "
                    f"{time_ms(torch, paged, flush):.4f} ms (equal to "
                    f"dense: {same})")
        del q, k, v, o, kp, vp
    ssd_kernel(torch, tag, flush, gen)


def ssd_kernel(torch, tag: str, flush, gen) -> None:
    import torch.nn.functional as F
    from repro_torch.kernels import mamba_scan as ms

    dev = "cuda"
    L, H, P, N, chunk = 512, 80, 64, 64, 128
    a = -torch.exp(0.5 * torch.randn(H, generator=gen, device=dev))
    for B in (8, 1):
        x = torch.randn(B, L, H, P, generator=gen, device=dev) \
            .to(torch.bfloat16)
        dt = F.softplus(torch.randn(B, L, H, generator=gen, device=dev) - 2)
        b = torch.randn(B, L, N, generator=gen, device=dev) \
            .to(torch.bfloat16)
        c = torch.randn(B, L, N, generator=gen, device=dev) \
            .to(torch.bfloat16)
        h0 = torch.randn(B, H, N, P, generator=gen, device=dev)
        run = lambda: ms.ssd_scan(x, dt, a, b, c, chunk=chunk, h0=h0)
        result(tag, f"ssd_scan B{B} x L{L} x H{H} x P{P}: "
                    f"{time_ms(torch, run, flush):.4f} ms")
        del x, dt, b, c, h0
    ssd_backward(torch, tag, flush, gen)


def ssd_backward(torch, tag: str, flush, gen) -> None:
    import torch.nn.functional as F
    from repro_torch.kernels import mamba_scan as ms

    dev, bf16 = "cuda", torch.bfloat16
    B, L, H, P, N, chunk = 4, 2048, 80, 64, 64, 128
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    x, dy = rnd(B, L, H, P).to(bf16), rnd(B, L, H, P).to(bf16)
    b, c = rnd(B, L, N).to(bf16), rnd(B, L, N).to(bf16)
    dt = F.softplus(rnd(B, L, H) - 2)
    a = -torch.exp(0.5 * rnd(H))
    for what, h0, dh in (("no h0", None, None),
                         ("h0 dh", rnd(B, H, N, P), rnd(B, H, N, P))):
        run = lambda: ms.ssd_scan_backward(x, dt, a, b, c, h0, dy, dh,
                                           chunk=chunk)
        result(tag, f"ssd_scan_backward B{B} x L{L} x H{H} x P{P} bf16 "
                    f"{what}: {time_ms(torch, run, flush):.4f} ms; per "
                    f"launch {launch_ms(torch, run, flush, 'ssd_bwd')}")
    if not hasattr(ms, "ssd_bwd_plan"):
        return
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chosen, times = ms.ssd_bwd_plan(B, L, H, chunk, sms)[0], []
    keep = ms.ssd_bwd_plan
    try:
        for hg in range(1, ms.MAX_BWD_HEADS + 1):
            ms.ssd_bwd_plan = lambda *_, hg=hg: (hg, -(-H // hg))
            t = time_ms(torch, lambda: ms.ssd_scan_backward(
                x, dt, a, b, c, None, dy, None, chunk=chunk), flush)
            times.append(f"{hg}{'*' if hg == chosen else ''} {t:.4f}")
    finally:
        ms.ssd_bwd_plan = keep
    result(tag, "ssd_scan_backward bf16 no h0 by heads a block (ms, * the "
                "planner's choice): " + ", ".join(times))


def groups(torch, tag: str) -> None:
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    for arch in ("tinyllama_1_1b", "zamba2_2_7b"):
        cfg = get_config(arch)
        model = build_model(cfg, impl="auto", device="cuda")
        params = model.init(0)
        gen = torch.Generator(device="cuda").manual_seed(1)
        B, T = 8, 512
        pos = torch.tensor(POS_T512, dtype=torch.int32, device="cuda")
        tokens = torch.randint(0, cfg.vocab, (B, T), generator=gen,
                               device="cuda", dtype=torch.int32)
        cache = model.init_cache(B, 2048)
        for _ in range(2):
            _, cache, _ = model.forward_chunk(params, tokens, None, cache, pos)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            model.forward_chunk(params, tokens, None, cache, pos)
            torch.cuda.synchronize()
        rows = [e for e in p.key_averages()
                if str(getattr(e, "device_type", "")).endswith("CUDA")
                and dev_us(e) > 0]
        part = lambda name: sum(dev_us(e) for e in rows if name in e.key)
        result(tag, f"{arch} prefill group B{B} x T{T}: device busy "
                    f"{sum(dev_us(e) for e in rows) / 1e3:.2f} ms, chunk "
                    f"attention {part('chunk_kernel') / 1e3:.2f} ms, ssd_scan "
                    f"{part('ssd_kernel') / 1e3:.2f} ms")
        del model, params, cache
        torch.cuda.empty_cache()


def serve(torch, tag: str) -> None:
    import chip_smoke as cs

    for what, kw in (("serve", {}),
                     ("paged", dict(page_size=64, max_cache_pages=257)),
                     ("hybrid-serve", dict(arch="zamba2_2_7b"))):
        engine, _, _, stats, edges = cs.serve_run(torch, what, **kw)
        pc = edges["prefill_chunk"]
        result(tag, f"{what}: {stats['throughput_tok_s']:.1f} tok/s, ttft "
                    f"p50 {stats['ttft_p50_s'] * 1e3:.1f} ms p95 "
                    f"{stats['ttft_p95_s'] * 1e3:.1f} ms, xfa prefill_chunk "
                    f"mean {pc.total_ns / pc.count / 1e6:.2f} ms x {pc.count},"
                    f" decode {stats['decode_s_per_tok'] * 1e3:.2f} ms/token")
        del engine
        torch.cuda.empty_cache()


def mla(torch, tag: str) -> None:
    import importlib.util
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dec

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(10)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev) \
        .to(torch.bfloat16)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    B, S, G, r, dr, ps = 8, 2048, 16, 512, 64, 64
    scale = (128 + 64) ** -0.5
    ckv, krope = rnd(B, S, r), rnd(B, S, dr)
    perm = (torch.randperm(B * S // ps, generator=gen, device=dev) + 1) \
        .to(torch.int32).reshape(B, S // ps)

    def pages(x):
        out = torch.full((1 + perm.numel(), ps, x.shape[-1]), 1e4,
                         dtype=x.dtype, device=dev)
        out[perm.reshape(-1).long()] = x.reshape(-1, ps, x.shape[-1])
        return out
    cp, rp = pages(ckv), pages(krope)
    latent = importlib.util.find_spec("repro_torch.kernels.mla_attention")
    if latent is not None:
        from repro_torch.kernels import mla_attention as m
        calls = {
            "decode": lambda q, n: m.decode_attention_latent(
                q, ckv, krope, kv_len=n, sm_scale=scale),
            "decode_paged": lambda q, n: m.decode_attention_latent_paged(
                q, cp, rp, block_table=perm, kv_len=n, sm_scale=scale),
            "chunk": lambda q, p: m.chunk_attention_latent(
                q, ckv, krope, pos=p, sm_scale=scale),
            "chunk_paged": lambda q, p: m.chunk_attention_latent_paged(
                q, cp, rp, block_table=perm, pos=p, sm_scale=scale)}
        copies = {}
    else:
        kv = lambda c, x: (torch.cat([c, x], dim=-1)[:, None],
                           F.pad(c, (0, dr))[:, None])
        k, v = kv(ckv, krope)
        kp, vp = kv(cp, rp)
        calls = {
            "decode": lambda q, n: dec.decode_attention(
                q, k, v, kv_len=n, sm_scale=scale),
            "decode_paged": lambda q, n: dec.decode_attention_paged(
                q, kp, vp, block_table=perm, kv_len=n, sm_scale=scale),
            "chunk": lambda q, p: dec.chunk_attention(
                q, k, v, pos=p, sm_scale=scale),
            "chunk_paged": lambda q, p: dec.chunk_attention_paged(
                q, kp, vp, block_table=perm, pos=p, sm_scale=scale)}
        copies = {  # the call as the PR 23 layer made it: copies inside
            "decode": lambda q, n: dec.decode_attention(
                q, *kv(ckv, krope), kv_len=n, sm_scale=scale),
            "decode_paged": lambda q, n: dec.decode_attention_paged(
                q, *kv(cp, rp), block_table=perm, kv_len=n, sm_scale=scale),
            "chunk": lambda q, p: dec.chunk_attention(
                q, *kv(ckv, krope), pos=p, sm_scale=scale),
            "chunk_paged": lambda q, p: dec.chunk_attention_paged(
                q, *kv(cp, rp), block_table=perm, pos=p, sm_scale=scale)}
    q1 = rnd(B, G, r + dr)
    lens = torch.tensor(KV_LEN, dtype=torch.int32, device=dev)
    runs = [(f"{name} kv_len {KV_LEN}", name, q1, lens)
            for name in ("decode", "decode_paged")]
    for T, pos_l in ((512, POS_T512), (8, POS_T8)):
        qc = rnd(B, G, T, r + dr)
        p = torch.tensor(pos_l, dtype=torch.int32, device=dev)
        runs += [(f"{name} T {T}", name, qc, p)
                 for name in ("chunk", "chunk_paged")]
    form = "latent, in place" if latent is not None else "k/v form"
    for what, name, q, arg in runs:
        ms = time_ms(torch, lambda: calls[name](q, arg), flush)
        extra = ""
        if name in copies:
            with_copies = time_ms(torch, lambda: copies[name](q, arg), flush)
            extra = f"; with the k/v copies inside {with_copies:.4f} ms"
        result(tag, f"mla {what} ({form}): {ms:.4f} ms{extra}")
    floor = time_ms(torch, lambda: torch.cuda._sleep(0), flush)
    split = [f"launch floor {floor:.4f} ms"]
    for n in (0, 1, 128, 2048):
        lens_n = torch.full((B,), n, dtype=torch.int32, device=dev)
        ms = time_ms(torch, lambda: calls["decode"](q1, lens_n), flush)
        split.append(f"kv_len {n} {ms:.4f} ms")
    result(tag, f"mla decode ({form}), where the time goes: "
                + ", ".join(split))
    mla_layer(torch, tag)
    if latent is None:
        return
    # the split plans' constants: decode range length, the chunk's target
    # blocks a row (each run checked against the plan in force)
    base = calls["decode"](q1, lens), calls["chunk"](runs[-1][2], runs[-1][3])
    for rng in (128, 256, 512):
        dec.WIDE_DECODE_RANGE = rng
        got = calls["decode"](q1, lens)
        ms = time_ms(torch, lambda: calls["decode"](q1, lens), flush)
        err = (got.float() - base[0].float()).abs().max().item()
        result(tag, f"mla decode ranges of {rng}: {ms:.4f} ms, "
                    f"{m.plan(B, G, 1, S, decode=True)[1]} ranges, max abs "
                    f"diff to the plan in force {err:.2e}")
    for blocks in (8, 16, 33):
        dec.WIDE_ROW_BLOCKS = blocks
        qc, p = runs[-1][2], runs[-1][3]
        got = calls["chunk"](qc, p)
        ms = time_ms(torch, lambda: calls["chunk"](qc, p), flush)
        err = (got.float() - base[1].float()).abs().max().item()
        result(tag, f"mla chunk T 8, target {blocks} blocks a row: "
                    f"{ms:.4f} ms, {m.plan(B, G, 8, S, decode=False)[1:3]} "
                    f"(ranges, columns), max abs diff {err:.2e}")


def mla_layer(torch, tag: str, calls: int = 10) -> None:
    """One MLA attention layer of deepseek-v2-lite (its first layer, full
    width) at a prefill chunk [8, 512] at offset 0 and a decode tick
    [8, 1] at offset 2047 against an [8, 2048] latent cache, under
    torch.profiler: the layer's device time a call, its attention
    kernel's, and its copy and fill kernels' (count and time a call)."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.layers import attention
    from repro_torch.models.transformer import _layer

    cfg = dataclasses.replace(get_config("deepseek_v2_lite_16b"), n_layers=2)
    model = build_model(cfg, device="cuda")
    lp = _layer(model.init(0)["stack_dense"]["stack"], 0)
    cache = {k: v[0] for k, v in model.init_cache(8, 2048).items()}
    gen = torch.Generator(device="cuda").manual_seed(12)
    attn_names = ("latent_kernel", "wide_kernel")
    copy_names = ("copy", "Copy", "fill", "Fill")
    with torch.no_grad():
        for S, at in ((512, 0), (1, 2047)):
            x = torch.randn((8, S, cfg.d_model), generator=gen,
                            device="cuda").to(torch.bfloat16)
            pos = torch.full((8,), at, dtype=torch.int32, device="cuda")
            positions = pos[:, None] + torch.arange(S, device="cuda")[None]
            run = lambda: attention(lp, x, model.rt, positions, cache, pos)
            for _ in range(3):
                run()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as p:
                for _ in range(calls):
                    run()
                torch.cuda.synchronize()
            rows = [e for e in p.key_averages() if dev_us(e) > 0]
            part = lambda names: [e for e in rows
                                  if any(n in e.key for n in names)]
            us = lambda es: sum(dev_us(e) for e in es) / calls
            n = lambda es: sum(e.count for e in es) / calls
            what = "decode tick [8, 1]" if S == 1 else "prefill chunk [8, 512]"
            result(tag, f"mla layer {what}: {us(rows) / 1e3:.4f} ms of "
                        f"device time a call; attention kernel "
                        f"{us(part(attn_names)) / 1e3:.4f} ms; copy and fill "
                        f"kernels x{n(part(copy_names)):.0f}, "
                        f"{us(part(copy_names)) / 1e3:.4f} ms")
    del model, lp, cache
    torch.cuda.empty_cache()



def flash(torch, tag: str) -> None:
    import inspect

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    keep = "keep_f32" in inspect.signature(fa.flash_attention).parameters
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(41)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    bf = lambda t: t.to(torch.bfloat16)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    for what, Hq, Hkv, causal in (("tinyllama", 32, 4, True),
                                  ("seamless", 16, 16, False)):
        q, k, v = bf(rnd(4, Hq, 2048, 64)), bf(rnd(4, Hkv, 2048, 64)), \
            bf(rnd(4, Hkv, 2048, 64))
        do = bf(rnd(4, Hq, 2048, 64))
        fwd = lambda **kw: fa.flash_attention(q, k, v, causal=causal, **kw)
        out = fwd(keep_f32=True) if keep else fwd()
        o, lse = (out[2] if keep else out[0]), out[1]
        t_fwd = time_ms(torch, fwd, flush)
        t_train = time_ms(torch, lambda: fwd(keep_f32=True), flush) \
            if keep else t_fwd
        t_bwd = time_ms(torch, lambda: fa.flash_attention_backward(
            q, k, v, o, lse, do, causal=causal), flush)
        result(tag, f"flash {what} q 4x{Hq}x2048x64 kv 4x{Hkv}x2048x64 "
                    f"{'causal' if causal else 'non-causal'}: forward "
                    f"{t_fwd:.4f} ms, training's forward {t_train:.4f} ms, "
                    f"backward {t_bwd:.4f} ms")
        del q, k, v, do, out, o, lse
    for D, G in ((64, 1), (128, 4), (80, 1)):
        Hkv, S = 2, 512
        common = 4.0 * rnd(1, 1, 1, D)
        q = bf(0.3 * rnd(1, Hkv * G, S, D) + 0.5 * common)
        k = bf(0.3 * rnd(1, Hkv, S, D) + common)
        v = bf(rnd(1, Hkv, S, D) + common)
        do = bf(rnd(1, Hkv * G, S, D))
        ins = [a.double().requires_grad_() for a in (q, k, v)]
        want = torch.autograd.grad(ref.attention(*ins, causal=False), ins,
                                   do.double())
        runs = {}
        ins = [a.clone().requires_grad_() for a in (q, k, v)]
        runs["kernels"] = torch.autograd.grad(fa.FlashAttention.apply(
            *ins, False, None, 0.0), ins, do)
        out = fa.flash_attention(q, k, v, causal=False)
        runs["o rounded"] = fa.flash_attention_backward(
            q, k, v, out[0].float() if keep else out[0], out[1], do,
            causal=False)
        ins = [a.clone().requires_grad_() for a in (q, k, v)]
        runs["plain bf16"] = torch.autograd.grad(
            ref.attention(*ins, causal=False), ins, do)
        rel = lambda a, b: ((a.double() - b).norm() / b.norm()).item()
        result(tag, f"flash grads, K rows sharing one component (D {D}, "
                    f"G {G}, S {S}): relative L2 of dq / dk / dv from f64: "
                    + "; ".join(f"{name} " + " / ".join(
                        f"{rel(g, w):.3e}" for g, w in zip(run, want))
                        for name, run in runs.items()))


if __name__ == "__main__":
    main()
