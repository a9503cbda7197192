#!/usr/bin/env python3
"""How far a bfloat16 train step can be reproduced: the JAX package's own
CRAFT step against itself at weights nudged by one float32 ulp, against its
float32 step, and the port's bfloat16 step against it (CPU).

    JAX_PLATFORMS=cpu python scripts/torch_bf16_step_spread.py [--hw 64x64 256x192] [--batch 2]

    JAX_PLATFORMS=cpu python scripts/torch_bf16_step_spread.py --init port --hw 64x64
    JAX_PLATFORMS=cpu python scripts/torch_bf16_step_spread.py --xla-strict
    JAX_PLATFORMS=cpu python scripts/torch_bf16_step_spread.py --blocks
    JAX_PLATFORMS=cpu python scripts/torch_bf16_step_spread.py --crnn-blocks

``--blocks`` prints the CRAFT step of ``tests/test_torch_dtype.py`` block by
block (each block of the port on the JAX step's own input and output
cotangent: gradients, input cotangent, running statistics) and whole;
``--crnn-blocks`` the CRNN blocks of that test against the JAX blocks as
XLA compiles them and with every op rounded.

``--xla-strict`` runs the JAX package's bfloat16 steps (CRAFT at 64x64 b2;
the CRNN's tiny config, b4, TPS + Attention, Attention, CTC and CTC +
TPS) twice, in two processes: once as they are and once under
``XLA_FLAGS=--xla_allow_excess_precision=false``, which rounds every op to
bfloat16 as an eager program does; it prints the losses and the relative
L2 of the gradients by top-level module.

For each canvas: one ``synthesize_batch`` (seed 11), the weights (``jax``:
the JAX ``VGG_UNet`` init, key 0; ``port``: the port's
``init_craft_state(0)``, the weights of ``tests/test_torch_dtype.py``),
``train_craft``'s loss (OHEM-MSE on float32 maps) and its gradients by
``jax.value_and_grad`` in bfloat16 and float32, each also at the
parameters times ``1 + 1e-7 * N(0, 1)``; and the port's
``init_craft_state(dtype=)`` model on the same weights and batch.  Prints
the losses, the gradient norms, the relative L2 of the gradients (all,
and ``basenet`` / ``upconv`` / ``conv_cls`` apart), one line a
comparison, and how far the port's bfloat16 maps are from the JAX
package's and how many of OHEM's hard negatives that flips.  A run at 64x64 takes ~1 minute, at 256x192 ~2.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lightly_ocr_tpu.models.vgg_unet import VGG_UNet as JVGG_UNet  # noqa: E402
from lightly_ocr_tpu.train import craft as jcraft  # noqa: E402
from lightly_ocr_tpu.utils.torch_import import import_torch_state_dict  # noqa: E402
from lightly_ocr_tpu_torch.train import craft  # noqa: E402
from lightly_ocr_tpu_torch.weights import state_dict_from_variables  # noqa: E402

NUDGE = 1e-7
PARTS = ("", "basenet.", "upconv", "conv_cls.")


def to_np(tree) -> dict:
    return {k: v.numpy().astype(np.float64)
            for k, v in state_dict_from_variables(jax.tree.map(np.asarray, tree)).items()}


def rel(a: dict, b: dict) -> str:
    out = []
    for p in PARTS:
        keys = [k for k in b if k.startswith(p)]
        x = np.concatenate([a[k].ravel() for k in keys])
        y = np.concatenate([b[k].ravel() for k in keys])
        out.append(f"{p.rstrip('.') or 'all'} {np.linalg.norm(x - y) / np.linalg.norm(y):.4g}")
    return ", ".join(out)


CRNN_TINY = dict(sequence="biLSTM", output_channel=64, hidden_size=32, height=32, width=64,
                 batch_max_len=8, character="abcdefghij", batch_size=4, num_fiducial=8)
CRNN_CASES = {"TPS + Attention": dict(prediction="Attention", transform="TPS"),
              "Attention": dict(prediction="Attention", transform="None"),
              "CTC": dict(prediction="CTC", transform="None"),
              "CTC + TPS": dict(prediction="CTC", transform="TPS")}


def jax_bf16_steps(out: str) -> None:
    """The JAX bfloat16 steps of ``--xla-strict``, their losses and
    gradients (``{case: ...}``) saved to ``out`` with ``np.savez``."""
    from lightly_ocr_tpu.config import Config
    from lightly_ocr_tpu.models.crnn import CRNNet
    from lightly_ocr_tpu.text.converters import build_converter
    from lightly_ocr_tpu.train.train_step import loss_fn

    arrays = {}
    batch = jcraft.synthesize_batch(np.random.default_rng(11), 2, 64, 64)
    v = jax.jit(lambda r: JVGG_UNet().init(r, jnp.zeros((1, 64, 64, 3)), True))(jax.random.key(0))
    model = JVGG_UNet(dtype=jnp.bfloat16)

    def craft_loss(p, s, b):
        (maps, _), _ = model.apply({"params": p, "batch_stats": s}, b["images"], True, mutable=["batch_stats"])
        maps = maps.astype(jnp.float32)
        return jcraft.ohem_mse(maps[..., 0], b["region"]) + jcraft.ohem_mse(maps[..., 1], b["affinity"])

    loss, g = jax.jit(jax.value_and_grad(craft_loss))(v["params"], v["batch_stats"], batch)
    arrays["CRAFT/loss"] = np.float64(loss)
    arrays.update({f"CRAFT/{k}": t for k, t in to_np({"params": g}).items()})
    for case, kw in CRNN_CASES.items():
        cfg = Config(**CRNN_TINY, **kw)
        conv = build_converter(cfg.prediction, cfg.character)
        b = {"images": np.random.default_rng(0).standard_normal((4, 32, 64, 1)).astype(np.float32)}
        words = ["abc", "de", "fghij", "a"]
        if cfg.prediction == "CTC":
            b["labels"], b["lengths"] = conv.encode_padded(words, cfg.batch_max_len)
        else:
            b["text"], b["lengths"] = conv.encode(words, cfg.batch_max_len)
        net = CRNNet(cfg, dtype=jnp.bfloat16)
        v = jax.jit(lambda r, cfg=cfg: CRNNet(cfg).init(
            r, jnp.zeros((2, 32, 64, 1)), jnp.zeros((2, cfg.num_steps + 1), jnp.int32), True))(jax.random.key(0))
        (loss, _), g = jax.jit(jax.value_and_grad(
            lambda p, s, b, net=net, cfg=cfg: loss_fn(net, cfg, p, s, b, True), has_aux=True))(
            v["params"], v["batch_stats"], b)
        arrays[f"{case}/loss"] = np.float64(loss)
        arrays.update({f"{case}/{k}": t for k, t in to_np({"params": g}).items()})
    np.savez(out, **arrays)


def xla_strict() -> None:
    """``--xla-strict``: the JAX bfloat16 steps as they are against the same
    steps with every op rounded (two processes)."""
    import subprocess
    import tempfile

    runs = []
    with tempfile.TemporaryDirectory() as d:
        for flags in ("", "--xla_allow_excess_precision=false"):
            out = os.path.join(d, f"{len(runs)}.npz")
            env = dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu")
            subprocess.run([sys.executable, __file__, "--dump", out], env=env, check=True)
            with np.load(out) as z:
                runs.append(dict(z))
    default, strict = runs
    for case in ("CRAFT", *CRNN_CASES):
        keys = [k for k in default if k.startswith(case + "/") and not k.endswith("/loss")]
        parts = sorted({k.split("/", 1)[1].split(".")[0] for k in keys})
        line = []
        for part in ["", *parts]:
            ks = [k for k in keys if k.split("/", 1)[1].startswith(part)]
            x = np.concatenate([strict[k].ravel() for k in ks])
            y = np.concatenate([default[k].ravel() for k in ks])
            line.append(f"{part or 'all'} {np.linalg.norm(x - y) / np.linalg.norm(y):.4g}")
        print(f"{case}: loss default {float(default[case + '/loss']):.6f}, strict "
              f"{float(strict[case + '/loss']):.6f}; gradients, strict against default, rel L2: "
              + ", ".join(line), flush=True)


def blocks() -> None:
    """``--blocks``: the CRAFT step of ``tests/test_torch_dtype.py`` (64x64
    b2, the port's init) block by block, each of the port's blocks on the
    JAX step's own input and output cotangent, and whole."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))
    import test_torch_dtype as t

    torch.set_num_threads(1)
    init = {k: v.clone() for k, v in craft.init_craft_state(0, device="cpu", dtype=torch.bfloat16)[0]
            .state_dict().items()}
    ref = t.craft_reference(init)
    got = t.craft_blocks.__wrapped__(ref)
    port = t.craft_port.__wrapped__(ref)
    every, want_all = {}, {}
    for b in t.BLOCKS:
        want, g = t.craft_block_reference(ref, b), got[b]["grads"]
        every.update(g)
        want_all.update(want)
        dx = (t.rel_l2({"a": got[b]["dx"].float()}, {"a": ref["dx"][b].float()})
              if b != "basenet.slice1" else float("nan"))
        stats = max([t.rel_l2({k: v}, {k: ref["stats"][k]}) for k, v in got[b]["stats"].items()] or [0.0])
        print(f"block {b}: gradients rel L2 {t.rel_l2(g, want):.4f}, norm off "
              f"{abs(t.norm_of(g) / t.norm_of(want) - 1):.5f}; float32 block {t.rel_l2(got[b]['grads32'], want):.4f}; "
              f"input cotangent {dx:.4f}; running statistics {stats:.2e}", flush=True)
    for n in ("basenet.slice5.2.bias", "conv_cls.8.bias"):
        print(f"{n}: the JAX step's gradient {np.round(ref['grads'][n].numpy()[:4], 4)}, the exact sum of its "
              f"cotangent {np.round(want_all[n][:4], 4)}, the port's block {np.round(every[n][:4], 4)}; rel L2 "
              f"JAX {t.rel_l2({n: ref['grads'][n]}, {n: want_all[n]}):.4f}, port {t.rel_l2({n: every[n]}, {n: want_all[n]}):.5f}")
    whole32 = t.rel_l2(ref["grads"], port["grads32"])
    print(f"blocks together: rel L2 {t.rel_l2(every, want_all):.4f}, norm off "
          f"{abs(t.norm_of(every) / t.norm_of(want_all) - 1):.5f}; JAX bfloat16 step against float32 {whole32:.4f}")
    print(f"whole step: loss port {port['loss']:.6f} JAX {ref['loss']:.6f}; gradients rel L2 "
          f"{t.rel_l2(port['grads'], ref['grads']):.4f}, norm off "
          f"{abs(t.norm_of(port['grads']) / t.norm_of(ref['grads']) - 1):.5f}; port bfloat16 against float32 "
          f"{t.rel_l2(port['grads'], port['grads32']):.4f}; maps max |diff| "
          f"{np.abs(port['maps'] - ref['maps']).max():.4g}; running statistics worst "
          f"{max(t.rel_l2({k: v}, {k: ref['stats'][k]}) for k, v in port['stats'].items()):.2e}")


def crnn_blocks() -> None:
    """``--crnn-blocks``: the CRNN blocks of ``tests/test_torch_dtype.py``
    (a decoder block, a BiLSTM, a ResNet block, the TPS's localization
    network whole) against the JAX blocks on the same input and output
    cotangent, as XLA compiles them and with every op rounded
    (``xla_allow_excess_precision`` off): the output's, the input
    cotangent's and the worst parameter gradient's relative L2."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))
    import test_torch_dtype as t
    from lightly_ocr_tpu.models.tps import LocalizationNetwork as JLocalizationNetwork
    from lightly_ocr_tpu_torch.models.layers import init_train_params
    from lightly_ocr_tpu_torch.models.tps import LocalizationNetwork

    torch.set_num_threads(1)
    for kind in (*t.BLOCK_TOL, "TPS localization"):
        if kind == "TPS localization":
            _, _, _, x, _, args = t.block_case("TPS")
            port = init_train_params(LocalizationNetwork(8, 1), torch.Generator().manual_seed(0)).train()
            port.localization_fc2.weight.data = 0.05 * torch.from_numpy(
                np.random.default_rng(7).standard_normal(port.localization_fc2.weight.shape).astype(np.float32))
            jblock = JLocalizationNetwork(8, dtype=jnp.bfloat16)
            shapes = jax.eval_shape(lambda: jblock.init(jax.random.key(0), x, True))
            v = import_torch_state_dict(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes),
                                        {k: w.numpy() for k, w in port.state_dict().items()})
            g = jnp.asarray(np.random.default_rng(9).standard_normal((4, 8, 2)), jnp.bfloat16)
        else:
            port, jblock, v, x, g, args = t.block_case(kind)

        def forward_backward(p, x, g, jblock=jblock, v=v, args=args):
            def apply(p, x):
                if "batch_stats" in v:
                    return jblock.apply({"params": p, "batch_stats": v["batch_stats"]}, x, *args,
                                        mutable=["batch_stats"])[0]
                return jblock.apply({"params": p}, x, *args)
            y, vjp = jax.vjp(apply, p, x)
            return y, vjp(g)

        state = {k: w.clone() for k, w in port.state_dict().items()}
        for mode, opts in (("as XLA compiles it", {}), ("every op rounded", {"xla_allow_excess_precision": False})):
            want, (jgrads, jdx) = jax.jit(forward_backward).lower(v["params"], x, g).compile(opts)(v["params"], x, g)
            port.load_state_dict(state)
            port.zero_grad(set_to_none=True)
            tx = t.to_torch(x).requires_grad_(True)
            out = port(tx)
            out.backward(t.to_torch(g))
            jg = t.to_state_dict({"params": jgrads})
            total = t.norm_of(jg)
            worst = max((t.rel_l2({n: w.grad}, {n: jg[n]}), n) for n, w in port.named_parameters()
                        if t.norm_of({n: jg[n]}) >= 1e-2 * total)
            print(f"{kind}, the JAX block {mode}: output {t.rel_l2({'y': out.detach().float()}, {'y': t.to_torch(want).float()}):.5f}, "
                  f"input cotangent {t.rel_l2({'dx': tx.grad.float()}, {'dx': t.to_torch(jdx).float()}):.5f}, "
                  f"worst gradient {worst[0]:.5f} ({worst[1]})", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hw", nargs="+", default=["64x64", "256x192"])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--init", choices=("jax", "port"), default="jax")
    ap.add_argument("--xla-strict", action="store_true")
    ap.add_argument("--blocks", action="store_true")
    ap.add_argument("--crnn-blocks", action="store_true")
    ap.add_argument("--dump", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dump:
        return jax_bf16_steps(args.dump)
    if args.xla_strict:
        return xla_strict()
    if args.blocks:
        return blocks()
    if args.crnn_blocks:
        return crnn_blocks()
    torch.set_num_threads(max(1, os.cpu_count() // 2))
    for hw in args.hw:
        H, W = (int(s) for s in hw.split("x"))
        batch = jcraft.synthesize_batch(np.random.default_rng(11), args.batch, H, W)
        v = jax.jit(lambda r: JVGG_UNet().init(r, jnp.zeros((1, 64, 64, 3)), True))(jax.random.key(0))
        if args.init == "port":
            sd = craft.init_craft_state(0, device="cpu")[0].state_dict()
            v = import_torch_state_dict(jax.tree.map(np.asarray, v), {k: t.numpy() for k, t in sd.items()})
        rng = np.random.default_rng(5)
        nudged = jax.tree.map(lambda a: (a * (1 + NUDGE * rng.standard_normal(a.shape))).astype(np.float32),
                              v["params"])
        res = {}
        for name, dt in (("bfloat16", jnp.bfloat16), ("float32", jnp.float32)):
            model = JVGG_UNet(dtype=dt)

            def loss_fn(p, s, b, model=model):
                (maps, _), _ = model.apply({"params": p, "batch_stats": s}, b["images"], True,
                                           mutable=["batch_stats"])
                maps = maps.astype(jnp.float32)
                return (jcraft.ohem_mse(maps[..., 0], b["region"])
                        + jcraft.ohem_mse(maps[..., 1], b["affinity"])), maps

            step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
            for tag, p in (("", v["params"]), (" nudged", nudged)):
                (loss, maps), g = step(p, v["batch_stats"], batch)
                res[name + tag] = (float(loss), to_np({"params": g}), np.asarray(maps))
        init = state_dict_from_variables(jax.tree.map(np.asarray, v))
        for name, dt in (("port bfloat16", torch.bfloat16), ("port float32", torch.float32)):
            model, _ = craft.init_craft_state(0, device="cpu", dtype=dt)
            model.load_state_dict(init, strict=True)
            maps = []
            model.conv_cls.register_forward_hook(lambda m, a, out: maps.append(out.permute(0, 2, 3, 1)))
            loss = craft.craft_loss(model, craft.batch_to(batch, "cpu"))
            loss.backward()
            res[name] = (loss.item(), {n: p.grad.double().numpy() for n, p in model.named_parameters()},
                         maps[0].detach().float().numpy())
        tag = f"b{args.batch} {H}x{W} ({args.init} init)"
        print(f"{tag}: losses " + ", ".join(f"{k} {r[0]:.6f}" for k, r in res.items()))
        norms = {k: float(np.sqrt(sum((g ** 2).sum() for g in r[1].values()))) for k, r in res.items()}
        print(f"{tag}: gradient norms " + ", ".join(f"{k} {n:.5f}" for k, n in norms.items()))
        for a, b in (("bfloat16 nudged", "bfloat16"), ("float32 nudged", "float32"), ("bfloat16", "float32"),
                     ("port bfloat16", "bfloat16"), ("port bfloat16", "float32"), ("port float32", "float32")):
            print(f"{tag}: gradients, {a} against {b}, rel L2: {rel(res[a][1], res[b][1])}", flush=True)
        flips = []
        for i, k in enumerate(("region", "affinity")):
            target = torch.from_numpy(batch[k])
            hard = [craft.ohem_masks(torch.from_numpy(res[n][2][..., i]), target)[2]
                    for n in ("bfloat16", "port bfloat16")]
            flips.append(f"{k} {int((hard[0] != hard[1]).sum())} of {int(hard[0].sum())}")
        print(f"{tag}: bfloat16 maps, port against JAX: max |diff| "
              f"{np.abs(res['port bfloat16'][2] - res['bfloat16'][2]).max():.4g} (max |map| "
              f"{np.abs(res['bfloat16'][2]).max():.4g}); OHEM hard negatives that differ: " + ", ".join(flips))


if __name__ == "__main__":
    main()
