"""Shared parts of tests/test_torch_mla_mesh.py and
tests/test_torch_hybrid_mesh.py: a smoke model of one family trained
under a mesh by the port against the JAX package, on the CPU.

The JAX side runs in ONE subprocess per test module with 8 host devices
and meshes of Auto axes (`JAX_SCRIPT`); the port's in one gloo world of
4 ranks (`torch_mesh_worlds.mla_mesh` / `hybrid_mesh`), whose (1, 2)
mesh runs over the model axis of each data row of its (2, 2) mesh.  Both
start once per module (`start`).  Inputs: the smoke config, the
reference's initial train state carried through numpy, a layer input x
[4, 16, d] with its output's cotangent, and the reference's batches.
The reference's train step is jitted with the train state's shardings
in and out, as its Trainer compiles it, so it compiles once a mesh.
"""

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
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.ckpt.manager import _flatten
    from repro.configs import get_smoke
    from repro.configs.base import TrainConfig
    from repro.data.pipeline import SyntheticLMData
    from repro.models import build_model, layers, mamba
    from repro.models import moe as moe_mod
    from repro.parallel.axes import named_sharding, runtime_mesh
    from repro.runtime import trainer as jt

    ARCH, LAYERS, (B, S), STEPS = %(arch)r, %(layers)r, %(batch)r, %(steps)d

    def mesh(shape):
        devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
        return jax.sharding.Mesh(devs, ("data", "model"),
                                 axis_types=(AxisType.Auto,) * 2)

    inp = dict(np.load(sys.argv[1]))
    x, ct = jnp.asarray(inp["x"]), jnp.asarray(inp["ct"])
    cfg = get_smoke(ARCH)
    jm = build_model(cfg, impl="ref")

    def layer_params(path, lead, groups):
        prefix = "s/params/" + "/".join(path) + "/"
        tree = {}
        for n, a in inp.items():
            rel = n[len(prefix):].split("/")
            if n.startswith(prefix) and rel[0] in groups:
                node = tree
                for u in rel[:-1]:
                    node = node.setdefault(u, {})
                node[rel[-1]] = jnp.asarray(a[(0,) * lead])
        return tree

    def apply(name, lp, x):
        zero = jnp.zeros((), jnp.float32)
        if name == "mla":
            return layers.attention(lp, x, jm.rt,
                                    jnp.arange(x.shape[1]))[0], zero, \\
                jm.table()
        if name == "moe":
            y, table, aux = moe_mod.moe(lp, x, jm.rt, jm.table(), mode="a2a")
            return y, aux, table
        return mamba.mamba_block(lp, x, jm.rt)[0], zero, jm.table()

    out = {}
    params = jm.init(jax.random.key(0))
    batches = [{k: jnp.asarray(v) for k, v in SyntheticLMData(
        cfg, B, S, seed=3).generate(i).items()} for i in range(STEPS)]
    for tag, shape in (("1x2", (1, 2)), ("2x2", (2, 2))):
        res = {"layer": {}}
        m = mesh(shape)
        with runtime_mesh(m):
            for name, path, lead, groups in LAYERS:
                def run(lp, x, name=name):
                    def f(lp, x):
                        y, aux, table = apply(name, lp, x)
                        return (y, aux), table
                    (y, aux), vjp, table = jax.vjp(f, lp, x, has_aux=True)
                    g = vjp((ct, jnp.ones((), jnp.float32)))
                    return y, aux, table, g
                y, aux, table, g = jax.jit(run)(
                    layer_params(path, lead, groups), x)
                lay = {"y": y, "aux": aux, "table": table, "dx": g[1]}
                for n, a in _flatten(g[0])[0]:
                    lay["d_" + n.replace("/", "_")] = a
                res["layer"][name] = {k: np.asarray(v)
                                      for k, v in lay.items()}

            def lg(p):
                (loss, (met, table)), g = jax.value_and_grad(
                    lambda p: jm.loss_fn(p, batches[0], jm.table()),
                    has_aux=True)(p)
                return loss, met["aux_loss"], table, g
            loss, aux, table, g = jax.jit(lg)(params)
            jcfg = TrainConfig(learning_rate=3e-3, warmup_steps=2,
                               total_steps=STEPS, ckpt_interval=0)
            js = jt.init_train_state(jm, jax.random.key(0), jcfg)
            ss = jt.state_shardings(js, m, jcfg.zero1)
            bs = jt.batch_shardings(batches[0], m)
            step = jax.jit(jt.make_train_step(jm, jcfg),
                           in_shardings=(ss, bs, named_sharding()),
                           out_shardings=(ss, None, named_sharding()))
            losses, auxes, norms = [], [], []
            for i in range(STEPS):
                js, met, _ = step(js, batches[i], jm.table())
                losses.append(float(met["loss"]))
                auxes.append(float(met["aux_loss"]))
                norms.append(float(met["grad_norm"]))
        res.update({"loss": float(loss), "aux_loss": float(aux),
                    "table": np.asarray(table),
                    "grads": {n: np.asarray(a) for n, a in _flatten(g)[0]},
                    "curve": {"loss": losses, "aux_loss": auxes,
                              "grad_norm": norms,
                              "state": {n: np.asarray(a)
                                        for n, a in _flatten(js)[0]}}})
        out[tag] = res
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
    print("OK")
""")


def flat_np(tree):
    return {name: np.asarray(leaf) for name, leaf in _flatten(tree)[0]}


def _inputs(arch, path):
    """The reference's initial train state of the smoke `arch`, a layer
    input x [4, 16, d] and its output's cotangent (that of a mean over
    the tokens)."""
    rng = np.random.default_rng(0)
    jm = jax_build(jax_smoke(arch), impl="ref")
    jstate = jax_trainer.init_train_state(jm, jax.random.key(0),
                                          JaxTrainConfig())
    d = jm.cfg.d_model
    B, S = worlds.FAMILY_BATCH
    arrays = {"x": rng.standard_normal((B, S, d)).astype(np.float32),
              "ct": (rng.standard_normal((B, S, d)) / (B * S)).astype(
                  np.float32),
              **{f"s/{n}": a for n, a in flat_np(jstate).items()}}
    np.savez(path, **arrays)
    return arrays


def start(arch, program, d):
    """(inputs, the JAX subprocess's results, the port ranks' results):
    both sides run at once."""
    inp = _inputs(arch, os.path.join(d, "inputs.npz"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    script = JAX_SCRIPT % {"arch": arch,
                           "layers": worlds.FAMILY_LAYERS[arch],
                           "batch": worlds.FAMILY_BATCH, "steps": STEPS}
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", script, os.path.join(d, "inputs.npz"),
         os.path.join(d, "jax.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
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
    return inp, ref, ranks


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
