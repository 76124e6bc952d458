"""Independent NumPy implementation of the Bergamot student model.

Written directly from the reference C++ semantics (slimt/Modules.cc,
slimt/Transformer.cc, slimt/TensorOps.cc) to serve as the golden oracle
for the JAX implementation — the analog of the reference's
generated-unit golden-blob tests (SURVEY.md §4.1). Deliberately simple
loops/numpy, no JAX.
"""

import math

import numpy as np


def quantize(x, mult):
    return np.clip(np.rint(x.astype(np.float32) * mult), -127, 127).astype(
        np.int8
    )


def affine(p, x):
    x_q = quantize(x, p["aq"])
    acc = x_q.astype(np.int32) @ p["q"].astype(np.int32)
    y = acc.astype(np.float32) / (p["aq"] * p["bq"])
    if "b" in p:
        y = y + p["b"]
    return y


def layer_norm(x, ln, eps=1e-6):
    mean = x.mean(axis=-1, keepdims=True)
    var = ((x - mean) ** 2).mean(axis=-1, keepdims=True)
    return (x - mean) / np.sqrt(var + eps) * ln["scale"] + ln["bias"]


def sinusoidal_signal(start, length, emb_dim):
    half = emb_dim // 2
    out = np.zeros((length, emb_dim), dtype=np.float32)
    log_inc = math.log(10000.0) / (half - 1.0)
    for p in range(start, start + length):
        for i in range(half):
            v = p * math.exp(i * -log_inc)
            out[p - start, i] = math.sin(v)
            out[p - start, i + half] = math.cos(v)
    return out


def embed(params, indices):
    return params["emb"]["q"][indices].astype(np.float32) / params["emb"][
        "scale"
    ]


def transform_embedding(x, start=0):
    emb_dim = x.shape[-1]
    return x * math.sqrt(emb_dim) + sinusoidal_signal(
        start, x.shape[-2], emb_dim
    )


def softmax(x):
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def split_heads(x, num_heads):
    b, t, e = x.shape
    return x.reshape(b, t, num_heads, e // num_heads).transpose(0, 2, 1, 3)


def join_heads(x):
    b, h, t, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b, t, h * d)


def attention(att, q_in, k_in, v_in, mask_add, num_heads):
    yq = split_heads(affine(att["q"], q_in), num_heads)
    yk = split_heads(affine(att["k"], k_in), num_heads)
    yv = split_heads(affine(att["v"], v_in), num_heads)
    d = yq.shape[-1]
    scores = np.einsum("bhqd,bhkd->bhqk", yq, yk) / math.sqrt(d)
    scores = scores + mask_add  # [B,1,1,Tk] broadcast
    attn = softmax(scores)
    out = np.einsum("bhqk,bhkd->bhqd", attn, yv)
    out = affine(att["o"], join_heads(out))
    return layer_norm(q_in + out, att["ln"]), attn


def ffn_block(layer, x):
    h = np.maximum(affine(layer["ffn"]["w1"], x), 0.0)
    y = affine(layer["ffn"]["w2"], h)
    return layer_norm(y + x, layer["ffn"]["ln"])


def encoder_forward(params, x, mask_add, num_heads):
    for layer in params["encoder"]:
        out, _ = attention(layer["att"], x, x, x, mask_add, num_heads)
        x = ffn_block(layer, out)
    return x


def ssru(rnn, state, x):
    f = 1.0 / (1.0 + np.exp(-affine(rnn["wf"], x)))
    p = rnn["w"]
    wx = affine({"q": p["q"], "aq": p["aq"], "bq": p["bq"]}, x)
    c_t = f * state + (1.0 - f) * wx
    y = np.maximum(c_t, 0.0)
    return layer_norm(x + y, rnn["ln"]), c_t


def output_logits(params, x, shortlist=None):
    emb_q = params["emb"]["q"]
    w = emb_q.T
    b = params["out"]["b"]
    if shortlist is not None:
        w = w[:, shortlist]
        b = b[shortlist]
    return affine(
        {"q": w, "aq": params["out"]["aq"], "bq": params["emb"]["scale"],
         "b": b},
        x,
    )


def greedy_decode(
    params, encoder_out, mask_add, eos_id, max_steps, num_heads,
    shortlist=None, decoder_position_zero=True,
):
    """Reference decode loop (slimt/Model.cc:111-185) in numpy."""
    batch, t_src, emb_dim = encoder_out.shape
    states = [
        np.zeros((batch, 1, emb_dim), np.float32) for _ in params["decoder"]
    ]
    complete = np.zeros(batch, bool)
    tokens, valid, aligns = [], [], []
    prev = None
    for step in range(max_steps):
        if np.all(complete):
            break
        if prev is None:
            x = np.zeros((batch, 1, emb_dim), np.float32)
        else:
            x = embed(params, prev[:, None])
        start = 0 if decoder_position_zero else step
        x = transform_embedding(x, start=start)
        guided = None
        for li, layer in enumerate(params["decoder"]):
            h, states[li] = ssru(layer["rnn"], states[li], x)
            out, attn = attention(
                layer["att"], h, encoder_out, encoder_out, mask_add, num_heads
            )
            x = ffn_block(layer, out)
            guided = attn
        logits = output_logits(params, x[:, 0, :], shortlist)
        choice = logits.argmax(axis=-1)
        word = shortlist[choice] if shortlist is not None else choice
        active = ~complete
        tokens.append(np.where(active, word, 0))
        valid.append(active.copy())
        aligns.append(
            np.where(active[:, None], guided[:, 0, 0, :], 0.0)
        )
        complete |= word == eos_id
        prev = word.astype(np.int64)
    n = len(tokens)
    pad = max_steps - n
    tokens = np.stack(tokens + [np.zeros(batch, np.int64)] * pad, 1)
    valid = np.stack(valid + [np.zeros(batch, bool)] * pad, 1)
    aligns = np.stack(
        aligns + [np.zeros((batch, t_src), np.float32)] * pad, 1
    )
    return tokens, valid, aligns


def make_additive_mask(mask):
    return ((1.0 - mask) * -99999999.0)[:, None, None, :].astype(np.float32)
