"""Training launcher of the PyTorch port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama_1_1b \\
        --steps 50 --batch 4 --seq 2048 [--resume] [--profile-dir DIR]

On the CPU, with the plain versions of the kernels and the smoke config:

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama_1_1b \\
        --smoke --device cpu --steps 4

--device defaults to cuda; without CUDA the launcher raises rather than
fall back.  The port's CLI reads the run's profile shards
(`python -m repro_torch.profile report DIR`), and so does the reference's;
the final shard carries the device fold (the `device` group: the
train_step count and, for an MoE model, each expert's load, the dropped
tokens and the router losses).  --layers N keeps the published widths
and cuts the depth (a model whose training state does not fit the card):
whole super-blocks for the hybrid (a multiple of attn_every) and the
xLSTM (of slstm_every), and for the enc-dec N / 2 encoder and N / 2
decoder layers (N even).
--xfa-collector HOST:PORT (with --profile-dir) streams them to a fleet
collector.  --metrics-out DIR writes each rank's step history, kernel
launches, collective counts, peak device memory, the device fold and,
under a mesh, the collective flows of the step its Trainer recorded to
DIR/rank<r>.json.
--capacity-factor sets an MoE model's (0: the config's).

Under a mesh (--mesh DxM, or PxDxM with a 'pod' axis; every family,
e.g. phi3_5_moe_42b or deepseek_v2_lite_16b at 1x2: expert and tensor
parallel over 'model'; zamba2_2_7b: its Mamba2 blocks split by ssm
heads; xlstm_1_3b: its mLSTM and sLSTM blocks by heads; internvl2_1b
and seamless_m4t_large_v2: the frontend projection split and gathered,
the attention, cross-attention included, and the MLPs split), one
process per rank, started by torchrun, whose world size must equal the
mesh's product:

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.train \
        --arch tinyllama_1_1b --smoke --device cpu --mesh 2x2 --steps 4

D is data parallel (each rank takes its rows of the same global batch,
ZeRO-1 optimizer state), M tensor parallel (and expert parallel for an
MoE model: its experts split over M, tokens exchanged by all-to-all).
Rank 0's closing report shows the recorded step's collective flows: wire
bytes by component and by mesh axis, and the collectives repeated at
one shape and site.  --dist-backend defaults to
nccl on CUDA (one rank per card) and gloo on the CPU; ranks sharing one
card ask for gloo (--dist-backend gloo).  --grad-compression int8 and
--deferred-grad-reduce set the trainer's knobs of the same names.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from ..ckpt.manager import CheckpointManager
from ..configs import get_config, get_smoke
from ..configs.base import TrainConfig
from ..core.session import XFASession
from ..data.pipeline import SyntheticLMData
from ..models import build_model
from ..kernels import ops
from ..parallel.axes import runtime_mesh
from ..parallel.mesh import collective_counts, init_distributed, shutdown
from ..runtime.trainer import Trainer, rank
from .mesh import make_mesh, parse_mesh


def flows_json(trainer: Trainer):
    """The recorded step's collectives (None without a mesh): its step,
    counts, the summary of the session's report and each flow."""
    rec = trainer.recorded
    if rec is None:
        return None
    return {"step": rec["step"], "collectives": rec["counts"],
            "summary": trainer.session.report().to_json()["collectives"],
            "flows": [dict(dataclasses.asdict(f), wire_bytes=f.wire_bytes)
                      for f in rec["flows"]]}


def cut_depth(cfg, layers: int):
    """cfg at `layers` layers, widths as published: a hybrid's depth a
    multiple of attn_every, an xLSTM's of slstm_every (whole
    super-blocks), an enc-dec's even (half encoder, half decoder); any
    other depth raises ValueError."""
    every = cfg.attn_every or cfg.slstm_every
    if every and layers % every:
        raise ValueError(f"--layers {layers}: {cfg.name} repeats a "
                         f"super-block of {every} layers, so the depth must "
                         f"be a multiple of {every}")
    if cfg.family == "audio":
        if layers % 2:
            raise ValueError(f"--layers {layers}: {cfg.name} is an "
                             f"encoder-decoder cut to half encoder, half "
                             f"decoder layers, so the depth must be even")
        return dataclasses.replace(cfg, n_layers=layers,
                                   enc_layers=layers // 2,
                                   dec_layers=layers // 2)
    return dataclasses.replace(cfg, n_layers=layers)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random initial weights")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers, widths as "
                         "published (0: the config's own depth); a "
                         "multiple of a hybrid's attn_every and of an "
                         "xLSTM's slstm_every; an enc-dec's even, half "
                         "encoder and half decoder layers")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="",
                    help="DxM or PxDxM (axes pod, data, model); the "
                         "world size must equal the product")
    ap.add_argument("--dist-backend", default="",
                    help="nccl or gloo (default: nccl on cuda, gloo on "
                         "cpu)")
    ap.add_argument("--capacity-factor", type=float, default=0.0,
                    help="an MoE model's capacity factor (0: the "
                         "config's)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--deferred-grad-reduce", action="store_true",
                    help="reduce the gradient over 'data' once after the "
                         "microbatches, not after each")
    ap.add_argument("--grad-compression", default="none",
                    help="none or int8 (error feedback)")
    ap.add_argument("--metrics-out", default="",
                    help="write each rank's history, kernel launches and "
                         "collective counts to DIR/rank<r>.json")
    ap.add_argument("--ckpt-dir", default="artifacts/train")
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--profile-dir", default="",
                    help="register the run + write XFA profile snapshot "
                         "rings here (reduce with: python -m "
                         "repro_torch.profile report DIR)")
    ap.add_argument("--profile-interval", type=int, default=0,
                    help="steps between snapshot-ring refreshes "
                         "(0: only at end)")
    ap.add_argument("--profile-keep-last", type=int, default=8,
                    help="snapshots kept per shard ring (0: unbounded)")
    ap.add_argument("--profile-max-age-s", type=float, default=0.0,
                    help="delete ring snapshots older than this (0: never)")
    ap.add_argument("--profile-max-bytes", type=int, default=0,
                    help="per-run-dir snapshot byte budget (0: unbounded)")
    from ..profile import kv_pair
    ap.add_argument("--profile-meta", action="append", default=[],
                    type=kv_pair, metavar="KEY=VALUE",
                    help="extra run-manifest metadata (repeatable)")
    ap.add_argument("--xfa-collector", default="", metavar="HOST:PORT",
                    help="stream snapshot-ring deltas to a fleet collector "
                         "(python -m repro_torch.profile collect); failures "
                         "degrade to the local ring, never kill the run")
    ap.add_argument("--xfa-host-label", default="",
                    help="override this process's host label in shard "
                         "names and manifests (default: hostname)")
    ap.add_argument("--xfa-budget-pct", type=float, default=0.0,
                    help="host-tracer overhead budget as a percent of wall "
                         "time (0: governor off)")
    args = ap.parse_args()

    mesh = None
    if args.mesh:
        shape, axes = parse_mesh(args.mesh)
        device = init_distributed(args.dist_backend or None, args.device)
        mesh = make_mesh(shape, axes)
    else:
        device = args.device
    if args.xfa_host_label:
        from ..profile import set_host_label
        set_host_label(args.xfa_host_label)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        try:
            cfg = cut_depth(cfg, args.layers)
        except ValueError as err:
            ap.error(str(err))
    if args.capacity_factor:
        cfg = dataclasses.replace(cfg, capacity_factor=args.capacity_factor)
    model = build_model(cfg, impl="auto", device=device)
    tcfg = TrainConfig(total_steps=args.steps, learning_rate=args.lr,
                       warmup_steps=max(args.steps // 10, 1),
                       microbatches=args.microbatches,
                       deferred_grad_reduce=args.deferred_grad_reduce,
                       grad_compression=args.grad_compression,
                       ckpt_interval=args.ckpt_interval,
                       xfa_overhead_budget=args.xfa_budget_pct / 100.0,
                       seed=args.seed)
    from ..profile import RetentionPolicy
    trainer = Trainer(model, tcfg,
                      CheckpointManager(args.ckpt_dir, async_save=True),
                      session=XFASession(device_spec=model.fold_spec),
                      profile_dir=args.profile_dir or None,
                      profile_interval=args.profile_interval,
                      profile_retention=RetentionPolicy(
                          keep_last=args.profile_keep_last,
                          max_age_s=args.profile_max_age_s,
                          max_bytes=args.profile_max_bytes),
                      profile_meta=dict(args.profile_meta),
                      xfa_collector=args.xfa_collector)
    # every rank reads the same global batch and takes its rows of it
    data = SyntheticLMData(cfg, args.batch, args.seq, seed=args.seed)
    with runtime_mesh(mesh):
        state, metrics = trainer.run(args.seed, data, args.steps,
                                     resume=args.resume)
    r = rank()
    if args.metrics_out:
        os.makedirs(args.metrics_out, exist_ok=True)
        with open(os.path.join(args.metrics_out, f"rank{r}.json"), "w") as f:
            json.dump({"rank": r, "mesh": args.mesh,
                       "history": trainer.history,
                       "launches": ops.launch_counts(),
                       "collectives": collective_counts(),
                       "peak_bytes": (torch.cuda.max_memory_allocated(
                           model.device) if model.device.type == "cuda"
                           else 0),
                       "collective_flows": flows_json(trainer),
                       "device_fold": (trainer.session.device_fold.to_json()
                                       if trainer.session.device_fold
                                       else None)}, f)
    print(f"done: {metrics}" if r == 0 else f"done (rank {r}): {metrics}")
    if r == 0:
        print(trainer.session.report().render(components=("app",)))
    shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
