"""Parameter names and shapes of the reference model, from the widths of a
configuration file alone: what the benchmark makes weights for. The names
are the port's ``state_dict`` keys, so a strict load into the port checks
this table against the program's own."""

from __future__ import annotations


def _cbr(out: dict, p: str, cin: int, cout: int, k: int) -> None:
    out[p + ".conv.weight"] = (cout, cin, k, k)
    out[p + ".conv.bias"] = (cout,)
    for name in ("weight", "bias", "running_mean", "running_var"):
        out[f"{p}.bn.{name}"] = (cout,)


def _conv_encoder(out: dict, p: str, cin: int, f: int) -> None:
    _cbr(out, p + ".in0", cin, f, 7)
    _cbr(out, p + ".in1", f, f, 3)
    for i in range(3):
        _cbr(out, f"{p}.down{i}", f, 2 * f, 3)
        _cbr(out, f"{p}.keep{i}", 2 * f, 2 * f, 3)
        f *= 2


def _pose_encoder(out: dict, p: str, m: dict) -> None:
    trunk = m["encoder_filters"]
    _conv_encoder(out, p + ".trunk", 3, trunk)
    f, prev, res, o = m["pose_decoder_filters"], trunk * 8, m["image_size"] // 8, 0
    while True:
        skip = 0 if o == 0 else trunk * 2 ** (3 - o)
        _cbr(out, f"{p}.dec{o}a", prev + skip, f, 3)
        _cbr(out, f"{p}.dec{o}b", f, f, 3)
        if res == m["image_size"]:
            out[p + ".heat.weight"] = (m["n_pts"], f, 1, 1)
            out[p + ".heat.bias"] = (m["n_pts"],)
            return
        _cbr(out, f"{p}.dec{o}c", f, f, 3)
        _cbr(out, f"{p}.dec{o}d", f, f, 3)
        prev, res, o = f, res * 2, o + 1
        if f >= 8:
            f //= 2


def _translator(out: dict, p: str, m: dict) -> None:
    f, prev = m["translator_filters"], 4 * m["encoder_filters"] + 2 * m["n_pts"]
    for o in range(3):
        _cbr(out, f"{p}.oct{o}a", prev, f, 3)
        _cbr(out, f"{p}.oct{o}b", f, f, 3)
        if o < 2:
            _cbr(out, f"{p}.oct{o}c", f, f, 3)
            _cbr(out, f"{p}.oct{o}d", f, f, 3)
            prev = f
            if f >= 8:
                f //= 2
    for head, ch in (("crude", 3), ("mask", 1)):
        out[f"{p}.{head}.weight"] = (ch, f, 3, 3)
        out[f"{p}.{head}.bias"] = (ch,)


def _dense(out: dict, p: str, din: int, dout: int) -> None:
    out[p + ".weight"] = (din, dout)
    out[p + ".bias"] = (dout,)


def _lstm(out: dict, p: str, din: int, cells) -> None:
    for i, h in enumerate(cells):
        out[f"{p}.lstm_{i}_kernel"] = (din + h, 4 * h)
        out[f"{p}.lstm_{i}_bias"] = (4 * h,)
        din = h


def stage1_generator(m: dict, p: str = "stage1") -> dict:
    out: dict = {}
    _conv_encoder(out, p + ".image_encoder.trunk", 3, m["encoder_filters"])
    _pose_encoder(out, p + ".pose_encoder", m)
    _translator(out, p + ".translator", m)
    return out


def motion_generator(m: dict, p: str = "stage2", encoder: bool = False) -> dict:
    out: dict = {}
    k2, cells = 2 * m["n_pts"], list(m["cell_info"])
    cond = k2 + m["n_action"]
    if encoder:
        _lstm(out, p + ".enc_lstm", k2, cells)
        _dense(out, p + ".enc_head", cells[-1] + cond, 2 * m["vae_dim"])
    _dense(out, p + ".dec_in", m["vae_dim"] + cond, 32)
    _lstm(out, p + ".dec_lstm", 32, cells)
    _dense(out, p + ".to_coord", cells[-1], k2)
    return out


def image_discriminator(m: dict, p: str = "image_discriminator") -> dict:
    out: dict = {}
    ch, prev = m["discriminator_filters"], 3
    for i in range(6):
        out[f"{p}.conv{i}.weight"] = (ch, prev, 4, 4)
        out[f"{p}.conv{i}.bias"] = (ch,)
        prev, ch = ch, 2 * ch
    out[p + ".logit.weight"] = (1, prev, 3, 3)
    return out


def seq_discriminator(m: dict, p: str = "discriminator") -> dict:
    out: dict = {}
    _lstm(out, p + ".lstm", 2 * m["n_pts"], list(m["cell_info"]))
    _dense(out, p + ".head", m["cell_info"][-1], 1)
    return out


def generation(m: dict) -> dict:
    """FinalGenerator's tree: the stage-1 generator and the motion decoder."""
    return {**stage1_generator(m), **motion_generator(m)}


def stage1_trainer(m: dict) -> dict:
    return {**stage1_generator(m), **image_discriminator(m)}


def stage2_trainer(m: dict) -> dict:
    return {**motion_generator(m, encoder=True), **seq_discriminator(m)}


VGG19_LAYOUT = (
    ("conv1_1", 64, False), ("conv1_2", 64, True),
    ("conv2_1", 128, False), ("conv2_2", 128, True),
    ("conv3_1", 256, False), ("conv3_2", 256, False), ("conv3_3", 256, False),
    ("conv3_4", 256, True),
    ("conv4_1", 512, False), ("conv4_2", 512, False), ("conv4_3", 512, False),
    ("conv4_4", 512, True),
    ("conv5_1", 512, False), ("conv5_2", 512, False), ("conv5_3", 512, False),
    ("conv5_4", 512, False),
)
VGG_TAPS = ("conv1_2", "conv2_2", "conv3_4", "conv4_4", "conv5_4")


def vgg19(max_width: int | None = None) -> dict:
    """vgg19.npy's layers as ``{name}.kernel`` (HWIO) and ``{name}.bias``."""
    out, cin = {}, 3
    for name, cout, _ in VGG19_LAYOUT:
        cout = min(cout, max_width) if max_width else cout
        out[name + ".kernel"] = (3, 3, cin, cout)
        out[name + ".bias"] = (cout,)
        cin = cout
    return out
