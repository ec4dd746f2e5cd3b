"""The plain reference: the networks of the keypoint video-prediction model
(NeurIPS 2019, YunjiKim/Unsupervised-Keypoint-Learning-for-Guiding-Class-
conditional-Video-Prediction) as functions of a flat parameter dict, in plain
PyTorch, NHWC at every boundary.

The dict is keyed as the port's ``state_dict`` keys it (``stage1.*``,
``stage2.*`` for generation; the trainers' generator and discriminator
trees), so one dict made by the benchmark feeds both. Nothing here imports
the port: this is a frozen copy of the plain math.

Every function computes in f32 through ``q`` (``PLAIN``: the identity).
``q`` is applied to each convolution's and product's operands, so the
control (:func:`fp8`) rounds exactly where a lower-precision program would.
TF32 is off (:func:`plain_backends`), so a f32 product is a f32 product.

Departures from a textbook form are the reference model's own: TF ``SAME``
padding (asymmetric at stride 2), the TF1 legacy 2x bilinear upsample, BN
with eps 1e-5 and the biased variance ``max(0, E[x^2] - E[x]^2)`` in train
mode, the LSTM gate order i, j, f, o with ``sigmoid(f + 1)``, ReLU on the
dense layers that the reference leaves at their default activation, and a
soft-argmax of the row and column means.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def plain_backends() -> None:
    """No TF32 anywhere: the reference's f32 is f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def PLAIN(x: torch.Tensor) -> torch.Tensor:
    return x


def _round(x: torch.Tensor, dtype, fmax: float) -> torch.Tensor:
    """``x`` rounded to a float8 ``dtype`` with a per-tensor scale (its amax
    maps to ``fmax``) and widened back."""
    s = x.detach().abs().amax().float().clamp(min=1e-30) / fmax
    return (x.detach() / s).to(dtype).to(x.dtype) * s


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """The control's precision, the one below the configuration's bf16: an
    operand rounded to float8 e4m3 with a per-tensor scale, and, in a
    training step's backward, the gradient that reaches it rounded to e5m2
    (as float8 training runs its backward products)."""
    return _Fp8.apply(x) if x.requires_grad else _round(x, torch.float8_e4m3fn, 448.0)


# ------------------------------------------------------------------ layers
def _same(size: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x, w, b=None, stride: int = 1, pre_pad: int = 0, q=PLAIN):
    """NHWC conv with an OIHW kernel, TF SAME padding after a zero pre-pad."""
    x = x.permute(0, 3, 1, 2)
    if pre_pad:
        x = F.pad(x, (pre_pad,) * 4)
    k = w.shape[-1]
    (t, bo), (l, r) = (_same(s, k, stride) for s in x.shape[2:])
    y = F.conv2d(F.pad(q(x), (l, r, t, bo)), q(w), stride=stride).permute(0, 2, 3, 1)
    return y if b is None else y + b


def bn(x, P, p: str, train: bool):
    if train:
        mean = x.mean(dim=(0, 1, 2))
        var = torch.clamp(torch.square(x).mean(dim=(0, 1, 2)) - torch.square(mean), min=0.0)
    else:
        mean, var = P[p + ".running_mean"], P[p + ".running_var"]
    return (x - mean) * (P[p + ".weight"] * torch.rsqrt(var + 1e-5)) + P[p + ".bias"]


def up2(x):
    """TF1 legacy 2x bilinear: out[2i] = in[i], out[2i+1] = (in[i] + in[i+1]) / 2,
    edge-clamped, along H then W."""
    for axis in (1, 2):
        n = x.shape[axis]
        nxt = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], dim=axis)
        shape = list(x.shape)
        shape[axis] = 2 * n
        x = torch.stack([x, (x + nxt) * 0.5], dim=axis + 1).reshape(shape)
    return x


def cbr(x, P, p: str, train: bool, stride: int = 1, q=PLAIN):
    """conv + BN + ReLU of the block ``p``."""
    return torch.relu(bn(conv(x, P[p + ".conv.weight"], P[p + ".conv.bias"], stride, q=q),
                         P, p + ".bn", train))


def dense(x, P, p: str, act: str | None = None, q=PLAIN):
    y = q(x) @ q(P[p + ".weight"]) + P[p + ".bias"]
    return torch.relu(y) if act == "relu" else torch.tanh(y) if act == "tanh" else y


def lstm(xs, P, p: str, q=PLAIN):
    """Stacked LSTM over [B, T, D] -> [B, T, H]; layer ``i``'s kernel is
    ``{p}.lstm_{i}_kernel`` [D + H, 4H], gates i, j, f, o."""
    n = 0
    while f"{p}.lstm_{n}_kernel" in P:
        n += 1
    b, t = xs.shape[:2]
    ks = [q(P[f"{p}.lstm_{i}_kernel"]) for i in range(n)]
    bs = [P[f"{p}.lstm_{i}_bias"] for i in range(n)]
    state = [(xs.new_zeros(b, k.shape[1] // 4), xs.new_zeros(b, k.shape[1] // 4)) for k in ks]
    outs = []
    for step in range(t):
        inp = xs[:, step]
        for i in range(n):
            c, h = state[i]
            g = q(torch.cat([inp, h], dim=-1)) @ ks[i] + bs[i]
            gi, gj, gf, go = torch.chunk(g, 4, dim=-1)
            c = torch.sigmoid(gf + 1.0) * c + torch.sigmoid(gi) * torch.tanh(gj)
            h = torch.sigmoid(go) * torch.tanh(c)
            state[i] = (c, h)
            inp = h
        outs.append(inp)
    return torch.stack(outs, dim=1)


# --------------------------------------------------------------- keypoints
def grid(n: int, device) -> torch.Tensor:
    return torch.linspace(-1.0, 1.0, n, device=device)


def soft_argmax(raw):
    """Raw maps [B, H, W, K] -> points [B, K, 2] (x, y): x the soft-argmax of
    the mean over H, y that of the mean over W, on the [-1, 1] grid."""
    px = torch.softmax(raw.mean(dim=1), dim=1)  # [B, W, K]
    py = torch.softmax(raw.mean(dim=2), dim=1)  # [B, H, K]
    x = (px * grid(raw.shape[2], raw.device)[:, None]).sum(dim=1)
    y = (py * grid(raw.shape[1], raw.device)[:, None]).sum(dim=1)
    return torch.stack([x, y], dim=-1)


def render(mu, size: int, inv_std: float):
    """Points [N, K, 2] -> Gaussian maps [N, size, size, K]."""
    g = grid(size, mu.device)
    ey = torch.exp(-torch.square(g[None, None] - mu[..., 1:2]) * inv_std ** 2)  # [N, K, H]
    ex = torch.exp(-torch.square(g[None, None] - mu[..., 0:1]) * inv_std ** 2)  # [N, K, W]
    return (ey[:, :, :, None] * ex[:, :, None, :]).permute(0, 2, 3, 1)


# ---------------------------------------------------------------- networks
def conv_encoder(x, P, p: str, train: bool, levels: int = 3, q=PLAIN):
    """[full, 1/2, 1/4, 1/8] features; ``levels`` < 3 stops early."""
    x = cbr(cbr(x, P, p + ".in0", train, q=q), P, p + ".in1", train, q=q)
    feats = [x]
    for i in range(levels):
        x = cbr(x, P, f"{p}.down{i}", train, 2, q=q)
        x = cbr(x, P, f"{p}.keep{i}", train, q=q)
        feats.append(x)
    return feats


def pose_encoder(x, P, p: str, train: bool, q=PLAIN):
    """Keypoints [B, K, 2] of frames [B, H, W, 3]."""
    feats = conv_encoder(x, P, p + ".trunk", train, q=q)
    h, o = feats[-1], 0
    while f"{p}.dec{o}a.conv.weight" in P:
        if o > 0:
            h = torch.cat([up2(h), feats[-1 - o]], dim=-1)
        for layer in "abcd":
            if f"{p}.dec{o}{layer}.conv.weight" in P:
                h = cbr(h, P, f"{p}.dec{o}{layer}", train, q=q)
        o += 1
    return soft_argmax(conv(h, P[p + ".heat.weight"], P[p + ".heat.bias"], q=q))


def translator(h, P, p: str, train: bool, q=PLAIN):
    """Joint embedding [N, h, w, C] -> (crude [N, 4h, 4w, 3], mask [N, 4h, 4w, 1])."""
    o = 0
    while f"{p}.oct{o}a.conv.weight" in P:
        if o > 0:
            h = up2(h)
        for layer in "abcd":
            if f"{p}.oct{o}{layer}.conv.weight" in P:
                h = cbr(h, P, f"{p}.oct{o}{layer}", train, q=q)
        o += 1
    crude = conv(h, P[p + ".crude.weight"], P[p + ".crude.bias"], q=q)
    mask = torch.sigmoid(conv(h, P[p + ".mask.weight"], P[p + ".mask.bias"], q=q))
    return crude, mask


def blend(background, crude, mask):
    return background * mask + crude * (1.0 - mask)


def patchgan(x, P, p: str, q=PLAIN):
    """Six pre-pad-1 4x4 stride-2 convs with leaky ReLU 0.01, then a pre-pad-1
    3x3 logit conv with no bias."""
    for i in range(6):
        x = F.leaky_relu(conv(x, P[f"{p}.conv{i}.weight"], P[f"{p}.conv{i}.bias"], 2, 1, q=q),
                         0.01)
    return conv(x, P[p + ".logit.weight"], None, 1, 1, q=q)


def motion_decode(z, first_pt, act, P, p: str, n_future: int, q=PLAIN):
    """[B, T, 2K] future keypoints: a ReLU dense layer to the first step's
    input, zeros after it, the stacked LSTM, a tanh head on every step."""
    inp0 = dense(torch.cat([z, first_pt, act], dim=-1), P, p + ".dec_in", "relu", q=q)
    xs = torch.cat([inp0[:, None], inp0.new_zeros(z.shape[0], n_future - 1, inp0.shape[-1])], 1)
    outs = lstm(xs, P, p + ".dec_lstm", q=q)
    return dense(outs, P, p + ".to_coord", "tanh", q=q)


def motion_encode(real_seq, first_pt, act, P, p: str, vae_dim: int, q=PLAIN):
    outs = lstm(real_seq, P, p + ".enc_lstm", q=q)
    logit = dense(torch.cat([outs[:, -1], first_pt, act], dim=-1), P, p + ".enc_head", "relu",
                  q=q)
    return logit[:, :vae_dim], logit[:, vae_dim:]


def seq_discriminator(seq, P, p: str, q=PLAIN):
    return dense(lstm(seq, P, p + ".lstm", q=q)[:, -1], P, p + ".head", "relu", q=q)
