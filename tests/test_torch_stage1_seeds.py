"""Where stage 1's first-step gradients leave JAX's, on the batches where
they do.

On ``test_torch_stage1.make_batch`` seeds 50, 55 and 72 the port's first
fused f32 step turns over first Adam steps of the pose encoder (on 55 of
the image encoder too) at |g| of up to a few % of their tensor's max; on
seeds 70, 10 and 51 none turns over. Each test takes all six seeds, from
``test_torch_stage1.py``'s randomized JAX trees (its ``jax_init``), at
smoke widths. JAX's side is its gradient as one jitted program, whose
first-step signs are those of its jitted ``train_step``. The backward is
cut at the boundaries between modules: the generated image (the loss's
gradient in the prediction), the current and future Gaussian maps (the
inputs of #4's backward), the keypoints (between #3's and #4's backwards)
and the raw pose maps (what #3's backward writes; on the CPU the port runs
the plain versions), and each cut is held against ``jax.vjp`` of the same
pieces of kpvid_tpu's generator. What the tests find:

- The forwards agree within 3e-5 of each tensor's max at every cut.
- At JAX's forward values the port's backward of JAX's cotangent is JAX's
  backward at every cut: the L1-of-ReLU perceptual loss and the PatchGAN
  within 1e-5 of the cotangent's max, the translator within 2e-5, the
  render (coords.py:67) and the soft-argmax (coords.py:32-63, its f32 grids
  on inclusive linspaces) within 1e-5, and the pose and image encoders
  (train-mode BN over the 2B pair, the TF1 upsample's edge clamp) within
  2e-4 of each parameter tensor's max.
- The gap is the step's kinks. ReLU, the L1 terms and the max-pools are not
  differentiable where their input crosses zero (or ties), and forwards
  that agree to 1e-5 put a few inputs on different sides. On seed 50 it is
  two ReLU inputs of the pose decoder (``dec2b`` at 1.3e-5, ``dec2c`` at
  1.5e-6, their layers' max 5.1 and 6.1): 401 first steps turn over. On 55
  it is one VGG ReLU input of ``conv1_2`` at 1.3e-4 (its max: 1009), which
  moves the loss's gradient in the prediction by 5.4% of its max: 195. On
  72 one ReLU input of the translator's ``oct1c`` at 4.3e-6 (its max:
  5.6): 15. One such input turns its element's cotangent on or off,
  train-mode BN spreads that over the channel, and the gradients above it
  move by a few % of their max. Every input that crosses lies within 1e-5
  of its layer's max of zero; where none crosses (70, 10, 51) nothing turns
  over. With the generator's ReLUs on JAX's side (the gradient still
  flowing through the port's) and JAX's cotangent at the generated image,
  the port's gradients are JAX's within 2e-4 of each tensor's max and no
  first step turns over, on all six seeds.
- JAX against itself: its gradient op by op against its jitted one turns
  over 7, 6, 38 and 0 first steps on seeds 50, 55, 70 and 72.

- The train CLI's first step from scratch (JAX's init draw, BN scale 1 and
  bias 0: test_cli_first_step_gap_is_the_kinks) turns first steps over at
  two ReLU inputs of the pose decoder and two of the loss's kinks; with the
  generator's ReLUs on JAX's side none turns over.

So the gap is conditioning, not a fault: the gradient of a ReLU network is
not continuous in its inputs, and two correct f32 programs land on
different sides of a kink. The biases of convs that feed a train-mode BN
and the heat map's bias have zero gradient in exact arithmetic (each side's
value is its own rounding) and are left out of the counts, as in
``test_torch_stage1.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kpvid_tpu.losses import generator_adv_loss as jax_adv_loss
from kpvid_tpu.models.layers import BatchNorm as JaxBatchNorm
from kpvid_tpu.ops import pair_fns as jax_pair_fns
from kpvid_tpu.ops.coords import heatmaps_to_keypoints
from kpvid_tpu.ops.coords import render_gaussian_maps as jax_render
from kpvid_tpu.ops.resize import upsample2x as jax_upsample2x
from kpvid_tpu_torch import bridge
from kpvid_tpu_torch.losses import generator_adv_loss
from kpvid_tpu_torch.losses.perceptual import (
    VGG19_LAYOUT,
    VGG_FEATURE_LAYERS,
    _vgg_mean,
    vgg19_features,
)
from kpvid_tpu_torch.models import BatchNorm
from kpvid_tpu_torch.models.layers import ConvBNReLU
from kpvid_tpu_torch.ops.coords import blend
from kpvid_tpu_torch.ops.keypoint_kernels import gaussian_render, pose_head
from kpvid_tpu_torch.ops.resize import upsample2x
from test_torch_stage1 import (  # noqa: F401  (jax_init is a module fixture)
    SMOKE1,
    jax_init,
    jax_trainer,
    make_batch,
    port_trainer,
    randomize,
)
from test_torch_train import record_updates

GAP_SEEDS = (50, 55, 70, 72)
CLEAN_SEEDS = (10, 51)
SEEDS = GAP_SEEDS + CLEAN_SEEDS
FWD_REL = 3e-5  # forwards at every cut, of each tensor's max
LOSS_REL = 1e-5  # the loss's gradient in the prediction, from JAX's prediction
TRANSLATOR_REL = 2e-5  # the maps' and embedding's cotangents through the translator
COORD_REL = 1e-5  # the render's and the soft-argmax's backwards
PARAM_REL = 2e-4  # a parameter tensor's gradient, of its max
KINK_REL = 1e-5  # a ReLU input on the other side of zero, of its layer's max
STEP_FLOOR = 1e-3  # first steps counted where |g| >= this share of the tensor's max
ZERO_GRAD = (".conv.bias", ".heat.bias")
NETS = ("stage1.pose_encoder.", "stage1.image_encoder.")


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


# ------------------------------------------------------------- the JAX side
@functools.lru_cache(maxsize=None)
def jax_pieces():
    """kpvid_tpu's stage-1 generator loss cut at the module boundaries, each
    piece jitted once (the shapes are the same for every seed)."""
    jt = jax_trainer()
    gen = jt.generator
    pair, unpair = jax_pair_fns(jt.pair_mode)
    hs, inv = SMOKE1["heatmap_size"], jt.config.model.heatmap_inv_std

    def apply(params, stats, method, *args):
        out, _ = gen.apply({"params": params, "batch_stats": stats}, *args, method=method,
                           mutable=["batch_stats"])
        return out

    @jax.jit
    def emb(params, stats, im):
        return apply(params, stats, lambda m, x: m.image_encoder(x, True)[-2], im)

    @jax.jit
    def raw(params, stats, im, fut):
        return apply(params, stats, lambda m, x: m.pose_encoder(x, True, return_raw_maps=True)[1],
                     pair(im, fut))

    @jax.jit
    def keypoints(raw_maps):  # as PoseEncoder does: coords.py:32-63 in f32
        return heatmaps_to_keypoints(raw_maps.astype(jnp.float32))

    @jax.jit
    def maps(mu):  # coords.py:67, as Stage1Generator renders them
        cur, fut = unpair(mu)
        return jax_render(cur, hs, hs, inv), jax_render(fut, hs, hs, inv)

    @jax.jit
    def final(params, stats, im, embedding, cur_map, fut_map):
        joint = jnp.concatenate([embedding, cur_map.astype(jt.dtype),
                                 fut_map.astype(jt.dtype)], axis=-1)
        crude, mask = apply(params, stats, lambda m, x: m.translator(x, True), joint)
        return im * mask + crude * (1.0 - mask)

    @jax.jit
    def loss(d_params, fut, pred):
        recon = jt._recon_loss(jt.vgg_params, (fut + 1.0) * 127.5, (pred + 1.0) * 127.5)
        return recon + jax_adv_loss(jt.discriminator.apply({"params": d_params}, pred))

    @jax.jit
    def full_grads(params, d_params, stats, im, fut):
        return jax.grad(lambda p: jt._g_loss(p, d_params, stats, im, fut)[0])(params)

    @jax.jit
    def pre_relu(params, stats, im, fut):
        _, mutated = gen.apply({"params": params, "batch_stats": stats}, im, fut, train=True,
                               mutable=["batch_stats", "intermediates"],
                               capture_intermediates=lambda m, _: isinstance(m, JaxBatchNorm))
        return mutated["intermediates"]

    return dict(emb=emb, raw=raw, keypoints=keypoints, maps=maps, final=final, loss=loss,
                full_grads=full_grads, pre_relu=pre_relu, unpair=unpair)


def bn_outputs(tree, path=()) -> dict:
    """capture_intermediates' BN outputs keyed by the port's module names
    (``pose_encoder.dec2c`` for ``pose_encoder/dec2c_bn``)."""
    out = {}
    for key, val in tree.items():
        if key == "__call__":
            out[".".join(path)] = np.asarray(val[0])
        else:
            out.update(bn_outputs(val, path + (key[:-3] if key.endswith("_bn") else key,)))
    return out


def jax_side(state, batch) -> dict:
    """JAX's forward at each cut, the cotangent there, each piece's
    parameter gradients, the whole gradient and every ReLU's input; pair
    batches as [current; future]."""
    f = jax_pieces()
    gp, bs = state.g_params, state.batch_stats
    im, fut = jnp.asarray(batch["image"]), jnp.asarray(batch["future_image"])
    emb, emb_vjp = jax.vjp(lambda p: f["emb"](p, bs, im), gp)
    raw, raw_vjp = jax.vjp(lambda p: f["raw"](p, bs, im, fut), gp)
    mu, mu_vjp = jax.vjp(f["keypoints"], raw)
    (cur_map, fut_map), maps_vjp = jax.vjp(f["maps"], mu)
    final, final_vjp = jax.vjp(lambda p, e, c, m: f["final"](p, bs, im, e, c, m), gp, emb,
                               cur_map, fut_map)
    loss, loss_vjp = jax.vjp(lambda x: f["loss"](state.d_params, fut, x), final)
    (g_final,) = loss_vjp(jnp.ones_like(loss))
    g_translator, g_emb, g_cur, g_fut = final_vjp(g_final)
    (g_mu,) = maps_vjp((g_cur, g_fut))
    (g_raw,) = mu_vjp(g_mu)
    (g_pose,) = raw_vjp(g_raw)
    (g_image,) = emb_vjp(g_emb)
    pieces = {}
    for tree in (g_translator, g_pose, g_image):
        for name, g in bridge.stage1_trainer_from_jax(jax.device_get(tree), {}, {}).items():
            pieces[name] = pieces.get(name, 0) + g.numpy()
    whole = bridge.stage1_trainer_from_jax(
        jax.device_get(f["full_grads"](gp, state.d_params, bs, im, fut)), {}, {})
    pre = bn_outputs(jax.device_get(f["pre_relu"](gp, bs, im, fut)))

    def split(x):  # JAX's pair layout -> [current; future]
        return np.concatenate([np.asarray(h) for h in f["unpair"](x)])

    pre = {k: split(v) if k.startswith("pose_encoder.") else v for k, v in pre.items()}
    fwd = dict(emb=emb, raw=split(raw), mu=split(mu), cur_map=cur_map, fut_map=fut_map,
               final=final, loss=loss)
    cot = dict(final=g_final, cur_map=g_cur, fut_map=g_fut, emb=g_emb, mu=split(g_mu),
               raw=split(g_raw))
    return {"fwd": {k: np.asarray(v) for k, v in fwd.items()},
            "cot": {k: np.asarray(v) for k, v in cot.items()},
            "pieces": pieces, "grads": {k: v.numpy() for k, v in whole.items()}, "pre": pre}


# ------------------------------------------------------------ the port side
def port_forward(trainer, batch) -> dict:
    """The port's stage-1 forward at the same cuts."""
    g = trainer.generator
    im, fut = trainer._pair_of(batch)
    hs, inv = SMOKE1["heatmap_size"], trainer.config.model.heatmap_inv_std
    emb = g.image_encoder(im, True)[-2]
    raw = g.pose_encoder.raw_maps(g._pair(im, fut), True)
    mu = pose_head(raw.contiguous())
    cur_mu, fut_mu = g._unpair(mu)
    cur_map, fut_map = (gaussian_render(m.contiguous(), hs, hs, inv, out_dtype=g.dtype)
                        for m in (cur_mu, fut_mu))
    crude, mask = g.translator.decode(torch.cat([emb, cur_map, fut_map], -1), True)
    final = blend(im, crude, mask)
    loss = trainer._recon(fut, final) + generator_adv_loss(trainer.discriminator(final))
    return dict(emb=emb, raw=raw, mu=mu, cur_map=cur_map, fut_map=fut_map, final=final,
                loss=loss)


def halves(trainer, x: torch.Tensor) -> torch.Tensor:
    """A pair batch in the port's layout as [current; future]."""
    return torch.cat(trainer.generator._unpair(x))


def named_grads(trainer, out, params, cot=None) -> dict:
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    grads = torch.autograd.grad(out, params, grad_outputs=cot, retain_graph=True,
                                allow_unused=True, materialize_grads=True)
    return {names[id(p)]: g.numpy() for p, g in zip(params, grads)}


class JaxSideOfKinks:
    """Forward hooks on the generator's BNs: where a ReLU input's sign
    differs from JAX's, the value becomes JAX's (and so the ReLU decides as
    JAX's does), while the gradient flows through the port's BN as before.
    ``flips`` records, per layer, (count, largest |input| among them, the
    layer's max |input|)."""

    def __init__(self, trainer, pre: dict):
        self.flips, self.hooks = {}, []
        for name, mod in trainer.generator.named_modules():
            if isinstance(mod, ConvBNReLU):
                want = torch.from_numpy(np.array(pre[name]))
                if name.startswith("pose_encoder."):  # [current; future] -> the port's pair
                    want = trainer.generator._pair(*want.chunk(2))
                self.hooks.append(mod.bn.register_forward_hook(
                    functools.partial(self._hook, name=name, want=want)))

    def _hook(self, mod, inputs, out, name, want):
        flip = (out > 0) != (want > 0)
        near = torch.maximum(out.detach().abs(), want.abs())[flip]
        self.flips[name] = (int(flip.sum()), float(near.max()) if flip.any() else 0.0,
                            float(want.abs().max()))
        return out + ((want - out) * flip).detach()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()


def turned_over(got: dict, want: dict, prefixes=("stage1.",)) -> dict:
    """name -> (max |got - want| / max |want|, first steps turned over at
    |want| >= STEP_FLOOR of the max), for each parameter tensor under
    ``prefixes`` whose gradient is not zero in exact arithmetic."""
    out = {}
    for name, g in got.items():
        w = want[name]
        top = float(np.abs(w).max())
        if not name.startswith(prefixes) or name.endswith(ZERO_GRAD) or top == 0.0:
            continue
        big = np.abs(w) >= STEP_FLOOR * top
        out[name] = (float(np.abs(g - w).max()) / top, int((np.sign(g) != np.sign(w))[big].sum()))
    return out


def loss_kinks(trainer, fut: torch.Tensor, pred_a: torch.Tensor, pred_b: torch.Tensor) -> dict:
    """The perceptual loss's kinks between two predictions of ``fut``: per
    VGG layer, the prediction's ReLU inputs on the other side of zero, and
    per tap the L1 terms f_gt - f_pred whose sign differs, each as (count,
    largest |input| among them, the layer's max |input|); under ``.pool``
    the max-pool windows whose argmax moves."""
    taps_gt = dict(zip(VGG_FEATURE_LAYERS, vgg19_features(trainer.vgg, (fut + 1.0) * 127.5)))
    xs = [(((p + 1.0) * 127.5).flip(-1) - _vgg_mean(p.device)).permute(0, 3, 1, 2)
          for p in (pred_a, pred_b)]
    out = {}
    for name, _, pool in VGG19_LAYOUT:
        k, b = trainer.vgg[name]
        pre = [F.conv2d(x, k, padding=1) + b[:, None, None] for x in xs]
        out[name] = _across_zero(*pre)
        xs = [torch.relu(x) for x in pre]
        if name in VGG_FEATURE_LAYERS:
            out[name + ".l1"] = _across_zero(*(taps_gt[name] - x for x in xs))
            if name == VGG_FEATURE_LAYERS[-1]:
                break
        if pool:
            (ya, ia), (yb, ib) = (F.max_pool2d(x, 2, 2, return_indices=True) for x in xs)
            out[name + ".pool"] = (int((ia != ib).sum()), 0.0, 0.0)
            xs = [ya, yb]
    return out


def _across_zero(a: torch.Tensor, b: torch.Tensor) -> tuple:
    flip = (a > 0) != (b > 0)
    near = torch.maximum(a.abs(), b.abs())[flip]
    return (int(flip.sum()), float(near.max()) if flip.any() else 0.0, float(a.abs().max()))


_RUNS = {}


def run(jax_state, seed: int) -> dict:
    """Both sides on ``make_batch(seed)``, once per seed."""
    if seed in _RUNS:
        return _RUNS[seed]
    batch = make_batch(seed)
    want = jax_side(jax_state, batch)
    trainer = port_trainer(jax_state)
    fwd = port_forward(trainer, batch)
    cut_names = ["final", "cur_map", "fut_map", "emb", "mu", "raw"]
    cots = torch.autograd.grad(fwd["loss"], [fwd[k] for k in cut_names], retain_graph=True)
    params = trainer._g_params
    own = named_grads(trainer, fwd["loss"], params)
    with JaxSideOfKinks(trainer, want["pre"]) as kinks:
        aligned_fwd = trainer.generator(*trainer._pair_of(batch), train=True)
    aligned = named_grads(trainer, aligned_fwd["final"], params, t(want["cot"]["final"]))
    # the first fused step of the trainer itself, as test_torch_stage1 runs it
    stepped = port_trainer(jax_state)
    first, _ = record_updates(stepped)
    stepped.train_step(batch)
    step_grads = {n: first[id(p)].numpy() for n, p in stepped.model.named_parameters()
                  if n.startswith("stage1.")}
    cots = {k: (halves(trainer, c) if k in ("raw", "mu") else c).numpy()
            for k, c in zip(cut_names, cots)}
    fwd = {k: (halves(trainer, v) if k in ("raw", "mu") else v).detach().numpy()
           for k, v in fwd.items()}
    _RUNS[seed] = dict(batch=batch, want=want, trainer=trainer, fwd=fwd, cot=cots, own=own,
                       aligned=aligned, flips=kinks.flips, step_grads=step_grads)
    return _RUNS[seed]


# ------------------------------------------------------------------- tests
@pytest.mark.parametrize("seed", SEEDS)
def test_first_step_gap_per_tensor(jax_init, seed):
    """Prints, for each pose- and image-encoder parameter tensor, the first
    step's gradient gap to JAX's as a share of the tensor's max |g| and the
    first Adam steps that turn over at |g| >= 1e-3 of it. The gradients are
    the trainer's own first update's (``record_updates``), which are the
    bisection's; on seeds 10 and 51 nothing turns over."""
    r = run(jax_init, seed)
    rows = turned_over(r["step_grads"], r["want"]["grads"], NETS)
    print(f"\nseed {seed}: tensor, gap / max |g|, first steps turned over")
    for name, (gap, n) in rows.items():
        print(f"  {name[len('stage1.'):]}: {gap:.3e}, {n}")
    total = sum(n for _, n in rows.values())
    print(f"seed {seed}: {total} first steps turned over in "
          f"{sum(n > 0 for _, n in rows.values())} tensors")
    for name, g in r["own"].items():
        if not name.endswith(ZERO_GRAD):
            np.testing.assert_allclose(r["step_grads"][name], g, rtol=0,
                                       atol=1e-6 * np.abs(g).max(), err_msg=name)
    if seed in CLEAN_SEEDS:
        assert total == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_forwards_agree_at_every_cut(jax_init, seed):
    """The embedding, the raw maps, the keypoints, both Gaussian maps and
    the generated image within 3e-5 of each tensor's max, the loss within
    rtol 1e-5; and JAX's pieces compose to JAX's whole gradient (within
    1e-4 of each tensor's max: the two sum the same terms in other orders)."""
    r = run(jax_init, seed)
    for k, want in r["want"]["fwd"].items():
        got = r["fwd"][k]
        assert got.shape == np.shape(want), k
        assert rel(got, want) <= (1e-5 if k == "loss" else FWD_REL), (k, rel(got, want))
    for name, g in r["want"]["grads"].items():
        if not name.endswith(ZERO_GRAD):
            np.testing.assert_allclose(r["want"]["pieces"][name], g, rtol=0,
                                       atol=1e-4 * np.abs(g).max(), err_msg=name)


@pytest.mark.parametrize("cut", ["loss", "translator", "render", "soft_argmax", "encoders"])
@pytest.mark.parametrize("seed", SEEDS)
def test_port_backward_of_jax_cotangent(jax_init, seed, cut):
    """At each cut, from JAX's forward values, the port's backward of JAX's
    cotangent against JAX's backward: the loss's gradient in the generated
    image within 1e-5 of its max; the translator's cotangents at the maps
    and the embedding within 2e-5 and its parameters' within 2e-4; the
    render's and the soft-argmax's within 1e-5; the pose and image
    encoders' parameters within 2e-4 of each tensor's max (ReLUs on JAX's
    side of zero in the translator and the encoders)."""
    r = run(jax_init, seed)
    trainer, w = r["trainer"], r["want"]
    if cut == "loss":
        pred = t(w["fwd"]["final"]).requires_grad_(True)
        fut = t(r["batch"]["future_image"])
        loss = trainer._recon(fut, pred) + generator_adv_loss(trainer.discriminator(pred))
        (g,) = torch.autograd.grad(loss, pred)
        assert rel(g.numpy(), w["cot"]["final"]) <= LOSS_REL
    elif cut == "translator":
        joint = torch.cat([t(w["fwd"][k]) for k in ("emb", "cur_map", "fut_map")], -1)
        joint.requires_grad_(True)
        with JaxSideOfKinks(trainer, w["pre"]):
            crude, mask = trainer.generator.translator.decode(joint, True)
        final = blend(t(r["batch"]["image"]), crude, mask)
        tr = [p for n, p in trainer.model.named_parameters() if n.startswith("stage1.translator.")]
        got = named_grads(trainer, final, tr, t(w["cot"]["final"]))
        (g_joint,) = torch.autograd.grad(final, joint, grad_outputs=t(w["cot"]["final"]))
        e, k = w["fwd"]["emb"].shape[-1], SMOKE1["n_pts"]
        g_joint = g_joint.numpy()
        for name, g in (("emb", g_joint[..., :e]), ("cur_map", g_joint[..., e:e + k]),
                        ("fut_map", g_joint[..., e + k:])):
            assert rel(g, w["cot"][name]) <= TRANSLATOR_REL, (name, rel(g, w["cot"][name]))
        rows = turned_over(got, w["pieces"])
        worst = max(rows.items(), key=lambda kv: kv[1][0])
        assert worst[1][0] <= PARAM_REL and not any(n for _, n in rows.values()), worst
    elif cut == "render":
        hs, inv = SMOKE1["heatmap_size"], trainer.config.model.heatmap_inv_std
        mu = t(w["fwd"]["mu"]).requires_grad_(True)
        maps = [gaussian_render(m.contiguous(), hs, hs, inv) for m in mu.chunk(2)]
        (g,) = torch.autograd.grad(maps, mu, grad_outputs=[t(w["cot"]["cur_map"]),
                                                            t(w["cot"]["fut_map"])])
        assert rel(g.numpy(), w["cot"]["mu"]) <= COORD_REL
    elif cut == "soft_argmax":
        raw = t(w["fwd"]["raw"]).requires_grad_(True)
        (g,) = torch.autograd.grad(pose_head(raw), raw, grad_outputs=t(w["cot"]["mu"]))
        assert rel(g.numpy(), w["cot"]["raw"]) <= COORD_REL
    else:
        g = trainer.generator
        im, fut = trainer._pair_of(r["batch"])
        with JaxSideOfKinks(trainer, w["pre"]):
            raw = g.pose_encoder.raw_maps(g._pair(im, fut), True)
            emb = g.image_encoder(im, True)[-2]
        raw = torch.cat(g._unpair(raw))
        params = [p for n, p in trainer.model.named_parameters() if n.startswith(NETS)]
        got = named_grads(trainer, [raw, emb], params, [t(w["cot"]["raw"]), t(w["cot"]["emb"])])
        rows = turned_over(got, w["pieces"], NETS)
        worst = max(rows.items(), key=lambda kv: kv[1][0])
        assert worst[1][0] <= PARAM_REL and not any(n for _, n in rows.values()), worst


@pytest.mark.parametrize("seed", SEEDS)
def test_gap_is_the_kinks(jax_init, seed):
    """Every ReLU input on the other side of zero from JAX's lies within
    1e-5 of its layer's max of zero; with the ReLUs on JAX's side and JAX's
    cotangent at the generated image the port's whole generator gradient is
    JAX's within 2e-4 of each tensor's max, and no first step turns over.
    So are the loss's kinks between the two predictions (VGG ReLU inputs and
    L1 terms); where neither side of the step has a kink between the two,
    nothing turns over. Prints the kinks and the gap of the loss's gradient
    in the prediction from the port's own prediction."""
    r = run(jax_init, seed)
    for name, (n, near, top) in r["flips"].items():
        assert n == 0 or near <= KINK_REL * top, (name, n, near, top)
    flips = {k: v for k, v in r["flips"].items() if v[0]}
    loss_gap = rel(r["cot"]["final"], r["want"]["cot"]["final"])
    with torch.no_grad():
        lk = loss_kinks(r["trainer"], t(r["batch"]["future_image"]), t(r["fwd"]["final"]),
                        t(r["want"]["fwd"]["final"]))
    print(f"\nseed {seed}: the loss's kinks between the two predictions "
          f"{ {k: v for k, v in lk.items() if v[0]} }")
    before = turned_over(r["own"], r["want"]["grads"])
    after = turned_over(r["aligned"], r["want"]["grads"])
    print(f"\nseed {seed}: ReLU inputs across zero {flips}; the loss's gradient in the "
          f"prediction {loss_gap:.2e} of its max from the port's own prediction; "
          f"{sum(n for _, n in before.values())} first steps turned over, "
          f"{sum(n for _, n in after.values())} with the kinks on JAX's side (worst gap "
          f"{max(g for g, _ in after.values()):.2e})")
    for name, (gap, n) in after.items():
        assert gap <= PARAM_REL and n == 0, (name, gap, n)
    for name, (n, near, top) in lk.items():
        assert n == 0 or near <= KINK_REL * top, (name, n, near, top)
    if not flips and not any(n for n, _, _ in lk.values()):  # no kink between them, no gap
        assert not any(n for _, n in before.values())
        assert loss_gap <= LOSS_REL


@pytest.fixture(scope="module")
def cli_first_step(tmp_path_factory):
    """The stage-1 train CLI's first step from scratch at training.seed 5
    (tests/test_torch_stage1.py's CLI run): JAX's ``init_state`` of the
    CLI's init key, BN scale 1 and bias 0, biases 0, and the first batch of
    the synthetic tree."""
    from kpvid_tpu_torch.data import HostDataPipeline, ImagePairDataset, make_synthetic_penn_tree
    from kpvid_tpu_torch.train.cli import init_key

    root = tmp_path_factory.mktemp("cli_step")
    make_synthetic_penn_tree(root)
    batches = HostDataPipeline(ImagePairDataset(str(root), "train", image_size=32), 2,
                               shuffle=True, repeat=True, seed=5).batches()
    batch = next(batches)
    batches.close()
    return jax.device_get(jax_trainer().init_state(init_key(5))), batch


def test_cli_first_step_gap_is_the_kinks(cli_first_step):
    """On the CLI's first step from scratch, where its parameters after 3
    steps leave JAX's train.py's (the CLI test prints by how much), first
    Adam steps turn over; with the generator's ReLUs on JAX's side and
    JAX's cotangent at the generated image none does: the same kinks as on
    the seeds above. Prints the ReLU inputs across zero (as a share of
    their layer's max), the loss's kinks and the gaps."""
    state, batch = cli_first_step
    want = jax_side(state, batch)
    trainer = port_trainer(state)
    fwd = port_forward(trainer, batch)
    own = named_grads(trainer, fwd["loss"], trainer._g_params)
    with JaxSideOfKinks(trainer, want["pre"]) as kinks:
        aligned_fwd = trainer.generator(*trainer._pair_of(batch), train=True)
    aligned = named_grads(trainer, aligned_fwd["final"], trainer._g_params,
                          t(want["cot"]["final"]))
    with torch.no_grad():
        lk = loss_kinks(trainer, t(batch["future_image"]), fwd["final"],
                        t(want["fwd"]["final"]))
    before = turned_over(own, want["grads"])
    after = turned_over(aligned, want["grads"])
    flips = {k: (n, near / top) for k, (n, near, top) in kinks.flips.items() if n}
    print(f"\nthe CLI's first step: ReLU inputs across zero {flips}; the loss's kinks "
          f"{ {k: v for k, v in lk.items() if v[0]} }; generated image "
          f"{rel(fwd['final'].detach().numpy(), want['fwd']['final']):.2e} of its max from "
          f"JAX's; {sum(n for _, n in before.values())} first steps turned over, "
          f"{sum(n for _, n in after.values())} with the kinks on JAX's side (worst gap "
          f"{max(g for g, _ in after.values()):.2e})")
    assert flips and sum(n for _, n in before.values()) > 0
    assert not any(n for _, n in after.values())


def test_jax_against_itself(jax_init):
    """JAX's own gradient of the same step, as one jitted program (the
    reference of the tests above, whose first-step signs are those of JAX's
    jitted ``train_step``) and op by op, turns first steps over on these
    batches too: its two programs land on different sides of the same kinks."""
    jt = jax_trainer()
    f = jax_pieces()
    st = jax_init
    step = jax.jit(jt.train_step)
    init = bridge.stage1_trainer_from_jax(jax.device_get(st.g_params), {}, {})
    total = 0
    for seed in GAP_SEEDS:
        b = {k: jnp.asarray(v) for k, v in make_batch(seed).items()}
        jitted = run(jax_init, seed)["want"]["grads"]
        eager = jax.grad(lambda p: jt._g_loss(p, st.d_params, st.batch_stats, b["image"],
                                              b["future_image"])[0])(st.g_params)
        eager = bridge.stage1_trainer_from_jax(jax.device_get(eager), {}, {})
        stepped = bridge.stage1_trainer_from_jax(jax.device_get(step(st, b)[0].g_params), {}, {})
        # Adam's first update is -lr * g / (|g| + eps): its sign is the gradient's
        minus_update = {k: (init[k] - v).numpy() for k, v in stepped.items()}
        assert not any(n for _, n in turned_over(minus_update, jitted).values()), seed
        n = sum(n for _, n in turned_over({k: v.numpy() for k, v in eager.items()},
                                          jitted).values())
        print(f"\nseed {seed}: JAX op by op against JAX jitted: {n} first steps turned over")
        total += n
    assert total > 0


def test_tf1_upsample_backward_matches_jax(rng):
    """The pose decoder's TF1 2x upsample with its edge clamp
    (kpvid_tpu/ops/resize.py:23-36): the backward of a random cotangent."""
    x = rng.normal(size=(2, 5, 3, 4)).astype(np.float32)
    ct = rng.normal(size=(2, 10, 6, 4)).astype(np.float32)
    _, vjp = jax.vjp(jax_upsample2x, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    xt = t(x).requires_grad_(True)
    (got,) = torch.autograd.grad(upsample2x(xt), xt, grad_outputs=t(ct))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_train_mode_batchnorm_backward_over_a_pair_matches_flax(rng):
    """Train-mode BN's backward over a 2B pair batch (the pose encoder's):
    the input's and both affine parameters' gradients against Flax's, each
    within 1e-5 of its max."""
    x = (rng.normal(size=(4, 6, 6, 8)) * 1.5 + 0.4).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    mod = JaxBatchNorm()
    v = jax.jit(lambda r: mod.init(r, x, train=True))(jax.random.PRNGKey(0))
    params = randomize(v["params"], rng)

    def f(p, inp):
        return mod.apply({"params": p, "batch_stats": v["batch_stats"]}, inp, train=True,
                         mutable=["batch_stats"])[0]

    _, vjp = jax.vjp(f, params, jnp.asarray(x))
    g_params, g_x = vjp(jnp.asarray(ct))
    bn = BatchNorm(8)
    p = params["BatchNorm_0"]
    with torch.no_grad():
        bn.weight.copy_(t(p["scale"]))
        bn.bias.copy_(t(p["bias"]))
    xt = t(x).requires_grad_(True)
    got = torch.autograd.grad(bn(xt, train=True), [xt, bn.weight, bn.bias], grad_outputs=t(ct))
    want = (g_x, g_params["BatchNorm_0"]["scale"], g_params["BatchNorm_0"]["bias"])
    for g, w in zip(got, want):
        assert rel(g.numpy(), w) <= 1e-5
