"""Shared parts of tests/test_torch_mla_mesh.py,
tests/test_torch_hybrid_mesh.py and
tests/test_torch_vlm_audio_ssm_mesh.py: smoke models of a family trained
under a mesh by the port against the JAX package, on the CPU.

The JAX side runs in ONE subprocess per test module with 8 host devices
and meshes of Auto axes (`JAX_SCRIPT`, every case of the module one
after the other); the port's in one gloo world of 4 ranks (a program of
`torch_mesh_worlds`), whose (1, 2) mesh runs over the model axis of each
data row of its (2, 2) mesh.  Both start once per module (`start`,
`start_cases`).  Inputs, per case (`torch_mesh_worlds.FamilyCase`): the
smoke config, the reference's initial train state carried through
numpy, a layer input x [4, 16, d] with its output's cotangent (and the
vlm's patches, the decoder layer's cross source), and the reference's
batches.
The reference's train step is jitted with the train state's shardings
in and out, as its Trainer compiles it, so it compiles once a mesh.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import torch

import torch_mesh_worlds as worlds
from repro.ckpt.manager import _flatten
from repro.configs import get_smoke as jax_smoke
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models import build_model as jax_build
from repro.runtime import trainer as jax_trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 1e-5, 1e-4
MESHES = ["1x2", "2x2"]
STEPS = worlds.FAMILY_STEPS

JAX_SCRIPT = textwrap.dedent("""
    import dataclasses, os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.ckpt.manager import _flatten
    from repro.configs import get_smoke
    from repro.configs.base import TrainConfig
    from repro.data.pipeline import SyntheticLMData
    from repro.models import build_model, layers, mamba, transformer, xlstm
    from repro.models import moe as moe_mod
    from repro.parallel.axes import named_sharding, runtime_mesh
    from repro.runtime import trainer as jt

    CASES = %(cases)r

    def mesh(shape):
        devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
        return jax.sharding.Mesh(devs, ("data", "model"),
                                 axis_types=(AxisType.Auto,) * 2)

    def run_case(case):
        inp = dict(np.load(os.path.join(sys.argv[1],
                                        "inputs-%%s.npz" %% case["key"])))
        x = jnp.asarray(inp["x"])
        cfg = dataclasses.replace(get_smoke(case["arch"]), **case["over"])
        jm = build_model(cfg, impl="ref")
        B, S = case["batch"]
        steps = case["steps"]

        def layer_params(sources):
            tree = {}
            for path, lead, groups in sources:
                prefix = "s/params/" + "/".join(path) + ("/" if path else "")
                for n, a in inp.items():
                    rel = n[len(prefix):].split("/")
                    if n.startswith(prefix) and rel[0] in groups:
                        node = tree
                        for u in rel[:-1]:
                            node = node.setdefault(u, {})
                        node[rel[-1]] = jnp.asarray(a[(0,) * lead])
            return tree

        def apply(name, lp, x, extra):
            zero = jnp.zeros((), jnp.float32)
            rt, table = jm.rt, jm.table()
            if name == "mla":
                return layers.attention(lp, x, rt,
                                        jnp.arange(x.shape[1]))[0], zero, \\
                    table
            if name == "moe":
                y, table, aux = moe_mod.moe(lp, x, rt, table, mode="a2a")
                return y, aux, table
            if name == "ssm":
                return mamba.mamba_block(lp, x, rt)[0], zero, table
            if name == "vlm":
                pre = transformer._project_patches(
                    lp, jnp.asarray(inp["patches"]), rt)
                h = jnp.concatenate([pre.astype(x.dtype), x], axis=1)
                y = transformer.decoder_layer(lp, h, rt, table,
                                              jnp.arange(h.shape[1]),
                                              "dense")[0]
                return y, zero, table
            if name == "dec":
                pos = jnp.arange(x.shape[1])
                h = layers.norm(lp["norm1"], x, rt)
                x = x + layers.attention(lp, h, rt, pos, causal=True)[0]
                h = layers.norm(lp["norm2"], x, rt)
                x = x + layers.attention(lp["cross"], h, rt, pos,
                                         kv=extra["src"], causal=False)[0]
                h = layers.norm(lp["norm3"], x, rt)
                return x + layers.mlp(lp, h, rt), zero, table
            if name == "mlstm":
                return xlstm.mlstm_block(lp, x, rt)[0], zero, table
            return xlstm.slstm_block(lp, x, rt)[0], zero, table

        out = {}
        params = jm.init(jax.random.key(0))
        batches = [{k: jnp.asarray(v) for k, v in SyntheticLMData(
            cfg, B, S, seed=3).generate(i).items()} for i in range(steps)]
        for tag, shape in (("1x2", (1, 2)), ("2x2", (2, 2))):
            res = {"layer": {}}
            m = mesh(shape)
            with runtime_mesh(m):
                for name, sources in case["layers"]:
                    ct = jnp.asarray(inp.get("ct_" + name, inp["ct"]))
                    extra = {k: jnp.asarray(inp[k]) for k in ("src",)
                             if name == "dec"}

                    def run(lp, x, extra, name=name, ct=ct):
                        def f(lp, x, extra):
                            y, aux, table = apply(name, lp, x, extra)
                            return (y, aux), table
                        (y, aux), vjp, table = jax.vjp(f, lp, x, extra,
                                                       has_aux=True)
                        g = vjp((ct, jnp.ones((), jnp.float32)))
                        return y, aux, table, g
                    y, aux, table, g = jax.jit(run)(
                        layer_params(sources), x, extra)
                    lay = {"y": y, "aux": aux, "table": table, "dx": g[1]}
                    for k, v in g[2].items():
                        lay["d" + k] = v
                    for n, a in _flatten(g[0])[0]:
                        lay["d_" + n.replace("/", "_")] = a
                    res["layer"][name] = {k: np.asarray(v)
                                          for k, v in lay.items()}
                if not steps:
                    out[tag] = res
                    continue

                def lg(p):
                    (loss, (met, table)), g = jax.value_and_grad(
                        lambda p: jm.loss_fn(p, batches[0], jm.table()),
                        has_aux=True)(p)
                    return loss, met["aux_loss"], table, g
                loss, aux, table, g = jax.jit(lg)(params)
                jcfg = TrainConfig(learning_rate=3e-3, warmup_steps=2,
                                   total_steps=steps, ckpt_interval=0)
                js = jt.init_train_state(jm, jax.random.key(0), jcfg)
                ss = jt.state_shardings(js, m, jcfg.zero1)
                bs = jt.batch_shardings(batches[0], m)
                step = jax.jit(jt.make_train_step(jm, jcfg),
                               in_shardings=(ss, bs, named_sharding()),
                               out_shardings=(ss, None, named_sharding()))
                losses, auxes, norms = [], [], []
                for i in range(steps):
                    js, met, _ = step(js, batches[i], jm.table())
                    losses.append(float(met["loss"]))
                    auxes.append(float(met["aux_loss"]))
                    norms.append(float(met["grad_norm"]))
            res.update({"loss": float(loss), "aux_loss": float(aux),
                        "table": np.asarray(table),
                        "grads": {n: np.asarray(a)
                                  for n, a in _flatten(g)[0]},
                        "curve": {"loss": losses, "aux_loss": auxes,
                                  "grad_norm": norms,
                                  "state": {n: np.asarray(a)
                                            for n, a in _flatten(js)[0]}}})
            out[tag] = res
        return out

    out = {case["key"]: run_case(case) for case in CASES}
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
    print("OK")
""")


def flat_np(tree):
    return {name: np.asarray(leaf) for name, leaf in _flatten(tree)[0]}


def _inputs(case, path):
    """The reference's initial train state of `case`'s smoke model, a
    layer input x [B, S, d] and its output's cotangent (that of a mean
    over the tokens); with a vlm layer the patches [B, P, frontend_dim]
    and the cotangent of its [B, P + S, d] output, with a decoder layer
    the cross-attention's source [B, S, d]."""
    rng = np.random.default_rng(0)
    jcfg = dataclasses.replace(jax_smoke(case.arch), **dict(case.over))
    jm = jax_build(jcfg, impl="ref")
    jstate = jax_trainer.init_train_state(jm, jax.random.key(0),
                                          JaxTrainConfig())
    cfg = jm.cfg
    d = cfg.d_model
    B, S = worlds.FAMILY_BATCH
    arrays = {"x": rng.standard_normal((B, S, d)).astype(np.float32),
              "ct": (rng.standard_normal((B, S, d)) / (B * S)).astype(
                  np.float32),
              **{f"s/{n}": a for n, a in flat_np(jstate).items()}}
    names = [name for name, _ in worlds.case_layers(case)]
    if "vlm" in names:
        P = cfg.n_patches
        arrays["patches"] = rng.standard_normal(
            (B, P, cfg.frontend_dim)).astype(np.float32)
        arrays["ct_vlm"] = (rng.standard_normal((B, P + S, d))
                            / (B * (P + S))).astype(np.float32)
    if "dec" in names:
        arrays["src"] = rng.standard_normal((B, S, d)).astype(np.float32)
    np.savez(path, **arrays)
    return arrays


def start_cases(cases, program, d):
    """({key: inputs}, {key: the JAX subprocess's results}, the port
    ranks' results) of the `worlds.FamilyCase`s: one JAX subprocess and
    one gloo world of 4 ranks running `program`, both at once."""
    inps = {c.key: _inputs(c, os.path.join(d, f"inputs-{c.key}.npz"))
            for c in cases}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    script = JAX_SCRIPT % {"cases": [
        {"key": c.key, "arch": c.arch, "over": dict(c.over),
         "layers": worlds.case_layers(c), "batch": c.batch,
         "steps": STEPS if c.full else 0} for c in cases]}
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", script, d, os.path.join(d, "jax.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs = worlds.start_world(program, 4, d)
    try:
        worlds.join(procs, d, program)
        _, err = jax_proc.communicate(timeout=worlds.JOIN_TIMEOUT_S)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert jax_proc.returncode == 0, err[-3000:]
    with open(os.path.join(d, "jax.pkl"), "rb") as f:
        ref = pickle.load(f)
    ranks = [torch.load(os.path.join(d, f"{program}-rank{r}.pt"),
                        weights_only=False) for r in range(4)]
    return inps, ref, ranks


def start(arch, program, d):
    """(inputs, the JAX subprocess's results, the port ranks' results) of
    one architecture's smoke model (`worlds.FAMILY_CASES[arch]`)."""
    inps, ref, ranks = start_cases([worlds.FAMILY_CASES[arch]], program, d)
    return inps[arch], ref[arch], ranks


def close(got, want, atol=ATOL, rtol=RTOL, what=""):
    np.testing.assert_allclose(torch.as_tensor(got).float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=what)


def close_fold(got, want, n_experts, what=""):
    """Fold tables: expert loads, drops and counts exactly; the router
    losses (slots E + 1 and E + 2) at rtol 1e-4."""
    got = torch.as_tensor(got).double().numpy()
    want = np.asarray(want, np.float64)
    E = n_experts
    exact = np.r_[np.arange(E + 1), np.arange(E + 3, len(want))]
    np.testing.assert_array_equal(got[exact], want[exact], err_msg=what)
    np.testing.assert_allclose(got[E + 1:E + 3], want[E + 1:E + 3],
                               rtol=RTOL, err_msg=what)


def close_grads(got, want, what=""):
    """The model's loss, aux loss and every gradient leaf (summed over
    'data', gathered over 'model')."""
    from repro_torch.tree import leaves_with_path
    close(got["loss"], want["loss"], what=f"{what} loss")
    close(got["aux_loss"], want["aux_loss"], what=f"{what} aux_loss")
    grads = dict(leaves_with_path(got["grads"]))
    assert sorted(grads) == sorted(want["grads"])
    for name, g in grads.items():
        close(g, want["grads"][name], what=f"{what} {name}")


def close_curve(got, want, what=""):
    """Losses, aux losses and grad norms of the steps, the final params
    and master weights (a third of the learning rate)."""
    from repro_torch.tree import leaves_with_path
    close(got["loss"], want["loss"], atol=0, what=f"{what} loss")
    close(got["aux_loss"], want["aux_loss"], atol=0, what=f"{what} aux")
    close(got["grad_norm"], want["grad_norm"], atol=0, rtol=1e-3,
          what=f"{what} grad_norm")
    state = dict(leaves_with_path(got["state"]))
    for n, x in state.items():
        if n.startswith(("params/", "opt/master/")):
            close(x, want["state"][n], atol=1e-3, rtol=1e-3,
                  what=f"{what} {n}")
    assert int(state["opt/step"]) == STEPS


def static_costs_equal(got, want):
    """Every rank registers one trace's costs of the reference's SPMD
    program: the global batch, all heads, the whole widths."""
    assert sorted(got) == sorted(want)
    for k in want:
        assert sorted(got[k]) == sorted(want[k]), k
        for m in want[k]:
            np.testing.assert_allclose(got[k][m], want[k][m], rtol=1e-9,
                                       err_msg=f"{k} {m}")


def flow_sites(curve):
    """{(component, kind, axis): count} of a Trainer's recorded step."""
    import collections
    return collections.Counter((f["component"], f["kind"], f["axis"])
                               for f in curve["flows"])
