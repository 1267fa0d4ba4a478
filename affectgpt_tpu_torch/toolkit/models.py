"""Traditional feature-level fusion baselines (MERBench toolkit), in PyTorch.

Port of affectgpt_tpu/toolkit/models.py (reference: toolkit/models/*.py —
attention.py, tfn.py, lmf.py, lf_dnn.py, ef_lstm.py, mult.py, misa.py,
...). Each model consumes utterance-level (or frame-level) audio/text/video
features and produces (features, emotion logits, valence, aux loss) — the
four-tuple contract of the reference trainers.

Parameter trees are dicts of tensors with the JAX package's keys and
layouts, so a converted JAX tree drops in; `init` draws from an explicit
`torch.Generator` on its device. The LSTM is a loop over t (JAX's
`lax.scan`), gates in the order i, f, g, o. Dropout keys are the port's
tuples of ints (`nn.fold_in`); a model trains with dropout iff `apply` is
given `train_rng`, and the masks are the port's, not JAX's draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from affectgpt_tpu_torch import registry
from affectgpt_tpu_torch.models import nn


@dataclass(frozen=True)
class FusionArgs:
    text_dim: int = 768
    audio_dim: int = 512
    video_dim: int = 512
    hidden_dim: int = 128
    output_dim1: int = 6  # discrete emotions
    output_dim2: int = 1  # valence
    rank: int = 4  # LMF rank
    num_heads: int = 4  # MULT heads
    num_layers: int = 2  # MULT layers
    # args.dropout, read by every reference baseline into its dropout sites;
    # train-mode only: active iff apply() receives train_rng
    dropout: float = 0.0
    # args.grad_clip: -1 disables, otherwise clip by this global norm
    grad_clip: float = -1.0
    feat_type: str = "utt"  # utt | frm_align | frm_unalign
    # Attention_TOPN stream dims; empty → the standard (audio, text, video)
    feat_dims: Tuple[int, ...] = ()

    @classmethod
    def tiny(cls):
        return cls(text_dim=12, audio_dim=10, video_dim=8, hidden_dim=16,
                   output_dim1=4, output_dim2=1, rank=2, num_heads=2, num_layers=1)


# -- shared encoders -----------------------------------------------------------


def _drop(key, rate: float, x):
    """Inverted train-mode dropout; identity when key is None or rate == 0."""
    if key is None or rate <= 0.0:
        return x
    return nn.dropout(key, rate, x)


def _site(key, i: int):
    """Stable per-site subkey; None propagates (eval mode)."""
    return None if key is None else nn.fold_in(key, i)


def _dr(train_rng, args: FusionArgs, i: int):
    """(key, rate) drop handle for site i, or None when dropout is off."""
    if train_rng is None or args.dropout <= 0.0:
        return None
    return (nn.fold_in(train_rng, i), args.dropout)


def _scalar_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=x.dtype, device=x.device)


def mlp_encoder_init(g: torch.Generator, in_dim, hidden, dtype=torch.float32):
    return {
        "fc1": nn.dense_init(g, in_dim, hidden, dtype=dtype),
        "fc2": nn.dense_init(g, hidden, hidden, dtype=dtype),
    }


def mlp_encoder(params, x, drop=None):
    """Two dense + ReLU layers; drop: optional (key, rate), applied after
    each activation."""
    key, rate = drop if drop is not None else (None, 0.0)
    h = _drop(_site(key, 0), rate, torch.relu(nn.dense(params["fc1"], x)))
    return _drop(_site(key, 1), rate, torch.relu(nn.dense(params["fc2"], h)))


def lstm_encoder_init(g: torch.Generator, in_dim, hidden, dtype=torch.float32):
    return {
        "wx": nn.dense_init(g, in_dim, 4 * hidden, dtype=dtype),
        "wh": nn.dense_nobias_init(g, hidden, 4 * hidden, dtype=dtype),
    }


def _lstm_step(p, xt, h, c):
    gates = nn.dense(p["wx"], xt) + nn.dense_nobias(p["wh"], h)
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm_encoder(params, x, drop=None):
    """[b, t, d] → last hidden [b, h], a loop over t. drop: optional (key,
    rate) on the returned hidden (the reference LSTMEncoder's output
    dropout)."""
    b = x.shape[0]
    hidden = params["wh"]["w"].shape[0]
    h = x.new_zeros((b, hidden))
    c = x.new_zeros((b, hidden))
    for t in range(x.shape[1]):
        h, c = _lstm_step(params, x[:, t], h, c)
    if drop is not None:
        h = _drop(drop[0], drop[1], h)
    return h


def _encoders_init(g, args: FusionArgs, dtype=torch.float32):
    init = mlp_encoder_init if args.feat_type == "utt" else lstm_encoder_init
    return {
        "audio": init(g, args.audio_dim, args.hidden_dim, dtype),
        "text": init(g, args.text_dim, args.hidden_dim, dtype),
        "video": init(g, args.video_dim, args.hidden_dim, dtype),
    }


def _encode_all(params, args: FusionArgs, batch, rng=None):
    """rng: train-mode key; each modality encoder gets its own dropout
    stream."""
    enc = mlp_encoder if args.feat_type == "utt" else lstm_encoder
    if args.dropout <= 0.0:
        rng = None

    def d(i):
        return None if rng is None else (nn.fold_in(rng, i), args.dropout)

    return (
        enc(params["audio"], batch["audios"], drop=d(0)),
        enc(params["text"], batch["texts"], drop=d(1)),
        enc(params["video"], batch["videos"], drop=d(2)),
    )


def _heads_init(g, in_dim, args: FusionArgs, dtype=torch.float32):
    return {
        "emo": nn.dense_init(g, in_dim, args.output_dim1, dtype=dtype),
        "val": nn.dense_init(g, in_dim, args.output_dim2, dtype=dtype),
    }


def _heads(params, feats):
    return nn.dense(params["emo"], feats), nn.dense(params["val"], feats)


def _with_one(x):
    return torch.cat([x.new_ones((x.shape[0], 1)), x], dim=1)


# -- Attention fusion (reference toolkit/models/attention.py) -------------------


@registry.register_model("toolkit_attention")
class AttentionFusion:
    @staticmethod
    def init(g, args: FusionArgs):
        return {
            "encoders": _encoders_init(g, args),
            "attention_mlp": mlp_encoder_init(g, args.hidden_dim * 3, args.hidden_dim),
            "fc_att": nn.dense_init(g, args.hidden_dim, 3),
            "heads": _heads_init(g, args.hidden_dim, args),
        }

    @staticmethod
    def apply(params, args: FusionArgs, batch, train_rng=None) -> Tuple:
        """train_rng: dropout in the three encoders + attention_mlp."""
        a, t, v = _encode_all(params["encoders"], args, batch, rng=_site(train_rng, 0))
        concat = torch.cat([a, t, v], dim=1)
        gate = nn.dense(params["fc_att"], mlp_encoder(
            params["attention_mlp"], concat, drop=_dr(train_rng, args, 1)))  # [b,3]
        stacked = torch.stack([a, t, v], dim=2)  # [b, h, 3]
        feats = torch.einsum("bhm,bm->bh", stacked, gate)
        emos, vals = _heads(params["heads"], feats)
        return feats, emos, vals, _scalar_zero(feats)


# -- TFN: tensor fusion (reference toolkit/models/tfn.py) ------------------------


@registry.register_model("toolkit_tfn")
class TFN:
    @staticmethod
    def init(g, args: FusionArgs):
        h1 = (args.hidden_dim + 1) ** 3
        return {
            "encoders": _encoders_init(g, args),
            "post1": nn.dense_init(g, h1, args.hidden_dim),
            "post2": nn.dense_init(g, args.hidden_dim, args.hidden_dim),
            "heads": _heads_init(g, args.hidden_dim, args),
        }

    @staticmethod
    def apply(params, args: FusionArgs, batch, train_rng=None) -> Tuple:
        """train_rng: encoder dropouts + post_fusion_dropout on the outer
        product before the post layers."""
        a, t, v = _encode_all(params["encoders"], args, batch, rng=_site(train_rng, 0))
        b = a.shape[0]
        a1, t1, v1 = (_with_one(x) for x in (a, t, v))
        # outer product fusion [b, (h+1)^3]
        fused = torch.einsum("bi,bj,bk->bijk", a1, t1, v1).reshape(b, -1)
        pf = _dr(train_rng, args, 1)
        if pf is not None:
            fused = _drop(pf[0], pf[1], fused)
        h = torch.relu(nn.dense(params["post1"], fused))
        h = torch.relu(nn.dense(params["post2"], h))
        emos, vals = _heads(params["heads"], h)
        return h, emos, vals, _scalar_zero(h)


# -- LMF: low-rank multimodal fusion (reference toolkit/models/lmf.py) -----------


@registry.register_model("toolkit_lmf")
class LMF:
    @staticmethod
    def init(g, args: FusionArgs):
        h1 = args.hidden_dim + 1
        factor = lambda: nn.normal(g, (args.rank, h1, args.hidden_dim), 0.02,  # noqa: E731
                                   torch.float32)
        return {
            "encoders": _encoders_init(g, args),
            "audio_factor": factor(),
            "text_factor": factor(),
            "video_factor": factor(),
            "fusion_weights": nn.normal(g, (1, args.rank), 0.02, torch.float32),
            "fusion_bias": torch.zeros((1, args.hidden_dim), device=g.device),
            "heads": _heads_init(g, args.hidden_dim, args),
        }

    @staticmethod
    def apply(params, args: FusionArgs, batch, train_rng=None) -> Tuple:
        """train_rng: encoder dropouts only (the reference defines
        post_fusion_dropout but never calls it)."""
        a, t, v = _encode_all(params["encoders"], args, batch, rng=_site(train_rng, 0))
        a1, t1, v1 = (_with_one(x) for x in (a, t, v))
        fa = torch.einsum("bi,rih->brh", a1, params["audio_factor"])
        ft = torch.einsum("bi,rih->brh", t1, params["text_factor"])
        fv = torch.einsum("bi,rih->brh", v1, params["video_factor"])
        zy = fa * ft * fv  # [b, rank, h]
        feats = torch.einsum("or,brh->bh", params["fusion_weights"], zy) + params["fusion_bias"]
        emos, vals = _heads(params["heads"], feats)
        return feats, emos, vals, _scalar_zero(feats)


# -- LF-DNN: late fusion DNN (reference toolkit/models/lf_dnn.py) ----------------


@registry.register_model("toolkit_lf_dnn")
class LFDNN:
    @staticmethod
    def init(g, args: FusionArgs):
        return {
            "encoders": _encoders_init(g, args),
            "post": mlp_encoder_init(g, args.hidden_dim * 3, args.hidden_dim),
            "heads": _heads_init(g, args.hidden_dim, args),
        }

    @staticmethod
    def apply(params, args: FusionArgs, batch, train_rng=None) -> Tuple:
        """train_rng: encoder dropouts + post_fusion_dropout on the concat
        before the post MLP."""
        a, t, v = _encode_all(params["encoders"], args, batch, rng=_site(train_rng, 0))
        fused = torch.cat([a, t, v], dim=1)
        pf = _dr(train_rng, args, 1)
        if pf is not None:
            fused = _drop(pf[0], pf[1], fused)
        feats = mlp_encoder(params["post"], fused)
        emos, vals = _heads(params["heads"], feats)
        return feats, emos, vals, _scalar_zero(feats)


# -- EF-LSTM: early fusion LSTM (reference toolkit/models/ef_lstm.py) ------------


@registry.register_model("toolkit_ef_lstm")
class EFLSTM:
    @staticmethod
    def init(g, args: FusionArgs):
        in_dim = args.audio_dim + args.text_dim + args.video_dim
        return {
            "lstm": lstm_encoder_init(g, in_dim, args.hidden_dim),
            "post": mlp_encoder_init(g, args.hidden_dim, args.hidden_dim),
            "heads": _heads_init(g, args.hidden_dim, args),
        }

    @staticmethod
    def apply(params, args: FusionArgs, batch, train_rng=None) -> Tuple:
        """train_rng: dropout on the LSTM final state and after the post
        linear + ReLU."""
        # frame-aligned inputs [b, t, d*]; early concat along features
        x = torch.cat([batch["audios"], batch["texts"], batch["videos"]], dim=-1)
        h = lstm_encoder(params["lstm"], x, drop=_dr(train_rng, args, 0))
        feats = mlp_encoder(params["post"], h, drop=_dr(train_rng, args, 1))
        emos, vals = _heads(params["heads"], feats)
        return feats, emos, vals, _scalar_zero(feats)


# -- MULT: crossmodal transformer (reference toolkit/models/mult.py) -------------


def _xattn_block_init(g, dim, heads, dtype=torch.float32):
    return {
        "ln_q": nn.layernorm_init(dim, dtype, device=g.device),
        "ln_kv": nn.layernorm_init(dim, dtype, device=g.device),
        "attn": nn.mha_init(g, dim, dim, heads, dtype=dtype),
        "ln_ffn": nn.layernorm_init(dim, dtype, device=g.device),
        "ffn_in": nn.dense_init(g, dim, dim * 4, dtype=dtype),
        "ffn_out": nn.dense_init(g, dim * 4, dim, dtype=dtype),
    }


def _xattn_block(params, q, kv, heads, drop=None):
    """drop: (key, rate) for the attention probabilities, each sublayer's
    output and the FFN's hidden (mult.py's attn/res/relu dropouts)."""
    key, rate = drop if drop is not None else (None, 0.0)
    h = nn.mha(params["attn"], nn.layernorm(params["ln_q"], q),
               nn.layernorm(params["ln_kv"], kv), heads,
               probs_drop=(None if key is None else (_site(key, 0), rate)))
    q = q + _drop(_site(key, 1), rate, h)
    f = torch.relu(nn.dense(params["ffn_in"], nn.layernorm(params["ln_ffn"], q)))
    f = nn.dense(params["ffn_out"], _drop(_site(key, 2), rate, f))
    return q + _drop(_site(key, 3), rate, f)


_MODALITIES = ("audio", "text", "video")


@registry.register_model("toolkit_mult")
class MULT:
    """Crossmodal transformer: each target modality attends to the other two
    streams, outputs concatenated."""

    @staticmethod
    def init(g, args: FusionArgs):
        d = args.hidden_dim
        proj = {
            "audio": nn.dense_init(g, args.audio_dim, d),
            "text": nn.dense_init(g, args.text_dim, d),
            "video": nn.dense_init(g, args.video_dim, d),
        }
        blocks = {
            f"{tgt}_from_{src}": [_xattn_block_init(g, d, args.num_heads)
                                  for _ in range(args.num_layers)]
            for tgt in _MODALITIES for src in _MODALITIES if tgt != src
        }
        return {"proj": proj, "blocks": blocks, "heads": _heads_init(g, d * 6, args)}

    @staticmethod
    def apply(params, args: FusionArgs, batch, train_rng=None) -> Tuple:
        """train_rng: embed dropout on the projected streams, the per-block
        dropouts and the final projection dropout before the heads."""
        on = train_rng is not None and args.dropout > 0.0
        streams = {
            "audio": nn.dense(params["proj"]["audio"], batch["audios"]),
            "text": nn.dense(params["proj"]["text"], batch["texts"]),
            "video": nn.dense(params["proj"]["video"], batch["videos"]),
        }
        if on:  # embed_dropout
            streams = {
                k: _drop(_site(_site(train_rng, 0), i), args.dropout, v)
                for i, (k, v) in enumerate(streams.items())
            }
        # utterance features become length-1 sequences
        streams = {k: v[:, None, :] if v.ndim == 2 else v for k, v in streams.items()}
        outs = []
        pair = 0
        for tgt in _MODALITIES:
            for src in _MODALITIES:
                if tgt == src:
                    continue
                q = streams[tgt]
                for li, block in enumerate(params["blocks"][f"{tgt}_from_{src}"]):
                    bd = None
                    if on:
                        bd = (_site(_site(train_rng, 1 + pair), li), args.dropout)
                    q = _xattn_block(block, q, streams[src], args.num_heads, drop=bd)
                outs.append(q.mean(dim=1))
                pair += 1
        feats = torch.cat(outs, dim=-1)
        if on:  # final proj dropout
            feats = _drop(_site(train_rng, 7), args.dropout, feats)
        emos, vals = _heads(params["heads"], feats)
        return feats, emos, vals, _scalar_zero(feats)


# -- MISA: modality-invariant/-specific (reference toolkit/models/misa.py) -------


@registry.register_model("toolkit_misa")
class MISA:
    @staticmethod
    def init(g, args: FusionArgs):
        d = args.hidden_dim
        return {
            "encoders": _encoders_init(g, args),
            "shared": nn.dense_init(g, d, d),
            "private": {m: nn.dense_init(g, d, d) for m in _MODALITIES},
            "recon": nn.dense_init(g, d, d),
            "fusion": mlp_encoder_init(g, d * 6, d),
            "heads": _heads_init(g, d, args),
        }

    @staticmethod
    def apply(params, args: FusionArgs, batch, train_rng=None) -> Tuple:
        """train_rng: encoder dropouts + the fusion MLP's dropout."""
        a, t, v = _encode_all(params["encoders"], args, batch, rng=_site(train_rng, 0))
        shared = {m: torch.sigmoid(nn.dense(params["shared"], x))
                  for m, x in zip(_MODALITIES, (a, t, v))}
        private = {m: torch.sigmoid(nn.dense(params["private"][m], x))
                   for m, x in zip(_MODALITIES, (a, t, v))}
        # aux losses: similarity of shared spaces (CMD proxy: mean diff) +
        # orthogonality of private vs shared + reconstruction
        sim = sum(
            torch.mean((shared[m1] - shared[m2]) ** 2)
            for m1, m2 in (("audio", "text"), ("audio", "video"), ("text", "video"))
        )
        diff = sum(
            torch.mean(torch.sum(shared[m] * private[m], dim=-1) ** 2)
            for m in _MODALITIES
        )
        recon = sum(
            torch.mean((nn.dense(params["recon"], shared[m] + private[m]) - x) ** 2)
            for m, x in zip(_MODALITIES, (a, t, v))
        )
        interloss = sim + 0.1 * diff + recon
        fused = torch.cat([shared["audio"], shared["text"], shared["video"],
                           private["audio"], private["text"], private["video"]], dim=-1)
        feats = mlp_encoder(params["fusion"], fused, drop=_dr(train_rng, args, 1))
        emos, vals = _heads(params["heads"], feats)
        return feats, emos, vals, interloss


# -- MMIM: MultiModal InfoMax (reference toolkit/models/mmim.py) ------------------


@registry.register_model("toolkit_mmim")
class MMIM:
    """Fusion MLP plus CPC-style InfoNCE between the fused representation
    and each unimodal stream, with bilinear critics."""

    @staticmethod
    def init(g, args: FusionArgs):
        d = args.hidden_dim
        return {
            "encoders": _encoders_init(g, args),
            "fusion": mlp_encoder_init(g, d * 3, d),
            "critic_a": nn.dense_nobias_init(g, d, d),
            "critic_t": nn.dense_nobias_init(g, d, d),
            "critic_v": nn.dense_nobias_init(g, d, d),
            "heads": _heads_init(g, d, args),
        }

    @staticmethod
    def _infonce(critic, fused, modality):
        # scores[i, j] = fused_i · W · modality_j ; positives on the diagonal
        proj = nn.dense_nobias(critic, fused)  # [b, d]
        scores = torch.einsum("id,jd->ij", proj, modality)
        logprobs = torch.log_softmax(scores, dim=-1)
        return -torch.mean(torch.diagonal(logprobs))

    @staticmethod
    def apply(params, args: FusionArgs, batch, train_rng=None) -> Tuple:
        """train_rng: encoder dropouts + fusion-MLP dropout."""
        a, t, v = _encode_all(params["encoders"], args, batch, rng=_site(train_rng, 0))
        feats = mlp_encoder(params["fusion"], torch.cat([a, t, v], dim=1),
                            drop=_dr(train_rng, args, 1))
        nce = (
            MMIM._infonce(params["critic_a"], feats, a)
            + MMIM._infonce(params["critic_t"], feats, t)
            + MMIM._infonce(params["critic_v"], feats, v)
        )
        emos, vals = _heads(params["heads"], feats)
        return feats, emos, vals, 0.1 * nce


# -- MFN: memory fusion network (reference toolkit/models/mfn.py) ----------------


def _step_key(train_rng, args: FusionArgs, t: int):
    """The dropout key of timestep t, or None when dropout is off: a fresh
    mask each step, like the reference's in-loop nn.Dropout calls."""
    if train_rng is None or args.dropout <= 0.0:
        return None
    return nn.fold_in(train_rng, t)


@registry.register_model("toolkit_mfn")
class MFN:
    """Three synced LSTMs + delta-memory attention + gated multi-view
    memory. Frame-level inputs [b, t, d_m]."""

    @staticmethod
    def init(g, args: FusionArgs):
        d = args.hidden_dim
        cat = 3 * d  # concat of the three LSTM cell states
        mem = d
        return {
            "lstm_a": lstm_encoder_init(g, args.audio_dim, d),
            "lstm_t": lstm_encoder_init(g, args.text_dim, d),
            "lstm_v": lstm_encoder_init(g, args.video_dim, d),
            "att1": mlp_encoder_init(g, 2 * cat, 2 * cat),
            "att2": mlp_encoder_init(g, 2 * cat, mem),
            "gamma1": mlp_encoder_init(g, 2 * cat + mem, mem),
            "gamma2": mlp_encoder_init(g, 2 * cat + mem, mem),
            "heads": _heads_init(g, 3 * d + mem, args),
        }

    @staticmethod
    def apply(params, args: FusionArgs, batch, train_rng=None) -> Tuple:
        """train_rng: att1/att2/gamma1/gamma2 dropout inside the per-step
        memory loop, a fresh mask each step."""
        d = args.hidden_dim
        a, t, v = batch["audios"], batch["texts"], batch["videos"]
        b = a.shape[0]
        ha, ca, ht, ct, hv, cv, mem = (a.new_zeros((b, d)) for _ in range(7))
        for step in range(a.shape[1]):
            kt = _step_key(train_rng, args, step)
            dr = lambda i: None if kt is None else (nn.fold_in(kt, i), args.dropout)  # noqa: E731
            prev_cat = torch.cat([ca, ct, cv], dim=-1)
            ha, ca = _lstm_step(params["lstm_a"], a[:, step], ha, ca)
            ht, ct = _lstm_step(params["lstm_t"], t[:, step], ht, ct)
            hv, cv = _lstm_step(params["lstm_v"], v[:, step], hv, cv)
            new_cat = torch.cat([ca, ct, cv], dim=-1)
            both = torch.cat([prev_cat, new_cat], dim=-1)  # [b, 2·3d]
            attention = torch.softmax(mlp_encoder(params["att1"], both, drop=dr(0)), dim=-1)
            attended = both * attention
            c_hat = torch.tanh(mlp_encoder(params["att2"], attended, drop=dr(1)))
            gate_in = torch.cat([both, mem], dim=-1)
            g1 = torch.sigmoid(mlp_encoder(params["gamma1"], gate_in, drop=dr(2)))
            g2 = torch.sigmoid(mlp_encoder(params["gamma2"], gate_in, drop=dr(3)))
            mem = g1 * mem + g2 * c_hat
        feats = torch.cat([ha, ht, hv, mem], dim=-1)
        emos, vals = _heads(params["heads"], feats)
        return feats, emos, vals, _scalar_zero(feats)


# -- Graph-MFN: MFN with a Dynamic Fusion Graph (reference graph_mfn.py) ----------


def _dfg_init(g, d, dtype=torch.float32):
    """Dynamic Fusion Graph over modality subsets {a,t,v,av,at,tv,atv}."""
    return {
        "pair_av": mlp_encoder_init(g, 2 * d, d),
        "pair_at": mlp_encoder_init(g, 2 * d, d),
        "pair_tv": mlp_encoder_init(g, 2 * d, d),
        "triple": mlp_encoder_init(g, 3 * d, d),
        "efficacies": nn.dense_init(g, 3 * d, 7),
    }


def _dfg_apply(params, a, t, v, drop=None):
    """The graph output: efficacy-weighted sum of vertex embeddings. drop:
    (key, rate) for the vertex MLPs."""
    key, rate = drop if drop is not None else (None, 0.0)
    dr = lambda i: None if key is None else (_site(key, i), rate)  # noqa: E731
    gates = torch.sigmoid(nn.dense(params["efficacies"], torch.cat([a, t, v], dim=-1)))  # [b, 7]
    av = mlp_encoder(params["pair_av"], torch.cat([a, v], dim=-1), drop=dr(0))
    at = mlp_encoder(params["pair_at"], torch.cat([a, t], dim=-1), drop=dr(1))
    tv = mlp_encoder(params["pair_tv"], torch.cat([t, v], dim=-1), drop=dr(2))
    atv = mlp_encoder(params["triple"], torch.cat([a, t, v], dim=-1), drop=dr(3))
    vertices = torch.stack([a, t, v, av, at, tv, atv], dim=1)  # [b, 7, d]
    return torch.einsum("bkd,bk->bd", vertices, gates)


@registry.register_model("toolkit_graph_mfn")
class GraphMFN:
    """MFN whose memory update is driven by a Dynamic Fusion Graph over the
    three cell states."""

    @staticmethod
    def init(g, args: FusionArgs):
        d = args.hidden_dim
        return {
            "lstm_a": lstm_encoder_init(g, args.audio_dim, d),
            "lstm_t": lstm_encoder_init(g, args.text_dim, d),
            "lstm_v": lstm_encoder_init(g, args.video_dim, d),
            "dfg": _dfg_init(g, d),
            "gamma1": mlp_encoder_init(g, 4 * d, d),
            "gamma2": mlp_encoder_init(g, 4 * d, d),
            "heads": _heads_init(g, 4 * d, args),
        }

    @staticmethod
    def apply(params, args: FusionArgs, batch, train_rng=None) -> Tuple:
        """train_rng: per-step dropout in the DFG vertex MLPs and the gamma
        gates, a fresh mask each step."""
        d = args.hidden_dim
        a, t, v = batch["audios"], batch["texts"], batch["videos"]
        b = a.shape[0]
        ha, ca, ht, ct, hv, cv, mem = (a.new_zeros((b, d)) for _ in range(7))
        for step in range(a.shape[1]):
            kt = _step_key(train_rng, args, step)
            dr = lambda i: None if kt is None else (nn.fold_in(kt, i), args.dropout)  # noqa: E731
            ha, ca = _lstm_step(params["lstm_a"], a[:, step], ha, ca)
            ht, ct = _lstm_step(params["lstm_t"], t[:, step], ht, ct)
            hv, cv = _lstm_step(params["lstm_v"], v[:, step], hv, cv)
            graph_out = _dfg_apply(params["dfg"], ca, ct, cv, drop=dr(0))  # [b, d]
            gate_in = torch.cat([ca, ct, cv, mem], dim=-1)
            g1 = torch.sigmoid(mlp_encoder(params["gamma1"], gate_in, drop=dr(1)))
            g2 = torch.sigmoid(mlp_encoder(params["gamma2"], gate_in, drop=dr(2)))
            mem = g1 * mem + g2 * torch.tanh(graph_out)
        feats = torch.cat([ha, ht, hv, mem], dim=-1)
        emos, vals = _heads(params["heads"], feats)
        return feats, emos, vals, _scalar_zero(feats)


# -- MCTN: cyclic-translation fusion (reference toolkit/models/mctn.py) -----------


@registry.register_model("toolkit_mctn")
class MCTN:
    """Translation-based fusion: encode text, translate to audio and video
    (and cyclically back), the encoder state as the joint representation;
    translation + cycle MSEs are the auxiliary losses."""

    @staticmethod
    def init(g, args: FusionArgs):
        d = args.hidden_dim
        return {
            "enc_text": lstm_encoder_init(g, args.text_dim, d),
            "to_audio": mlp_encoder_init(g, d, d),
            "audio_out": nn.dense_init(g, d, args.audio_dim),
            "to_video": mlp_encoder_init(g, d, d),
            "video_out": nn.dense_init(g, d, args.video_dim),
            "cycle_text": nn.dense_init(g, d, args.text_dim),
            "heads": _heads_init(g, d, args),
        }

    @staticmethod
    def apply(params, args: FusionArgs, batch, train_rng=None) -> Tuple:
        """train_rng: dropout on the encoder state + the translation MLPs."""
        t_seq = batch["texts"]
        rep = lstm_encoder(params["enc_text"], t_seq, drop=_dr(train_rng, args, 0))  # [b, d]
        audio_target = batch["audios"].mean(dim=1)
        video_target = batch["videos"].mean(dim=1)
        text_target = t_seq.mean(dim=1)

        ha = mlp_encoder(params["to_audio"], rep, drop=_dr(train_rng, args, 1))
        hv = mlp_encoder(params["to_video"], rep, drop=_dr(train_rng, args, 2))
        audio_hat = nn.dense(params["audio_out"], ha)
        video_hat = nn.dense(params["video_out"], hv)
        text_cycle = nn.dense(params["cycle_text"], ha)  # audio-space → text

        interloss = (
            torch.mean((audio_hat - audio_target) ** 2)
            + torch.mean((video_hat - video_target) ** 2)
            + torch.mean((text_cycle - text_target) ** 2)
        )
        emos, vals = _heads(params["heads"], rep)
        return rep, emos, vals, interloss


# -- MFM: factorized generative-discriminative fusion (reference mfm.py) ----------


@registry.register_model("toolkit_mfm")
class MFM:
    """Multimodal Factorization Model: a shared discriminative factor plus
    modality-specific generative factors with reconstruction losses."""

    @staticmethod
    def init(g, args: FusionArgs):
        d = args.hidden_dim
        return {
            "encoders": _encoders_init(g, args),
            "shared": mlp_encoder_init(g, 3 * d, d),
            "factor_a": mlp_encoder_init(g, d, d),
            "factor_t": mlp_encoder_init(g, d, d),
            "factor_v": mlp_encoder_init(g, d, d),
            "recon_a": nn.dense_init(g, 2 * d, args.audio_dim),
            "recon_t": nn.dense_init(g, 2 * d, args.text_dim),
            "recon_v": nn.dense_init(g, 2 * d, args.video_dim),
            "heads": _heads_init(g, d, args),
        }

    @staticmethod
    def apply(params, args: FusionArgs, batch, train_rng=None) -> Tuple:
        """train_rng: encoder dropouts + the factor MLPs' dropout."""
        a, t, v = _encode_all(params["encoders"], args, batch, rng=_site(train_rng, 0))
        shared = mlp_encoder(params["shared"], torch.cat([a, t, v], dim=-1),
                             drop=_dr(train_rng, args, 1))
        fa = mlp_encoder(params["factor_a"], a, drop=_dr(train_rng, args, 2))
        ft = mlp_encoder(params["factor_t"], t, drop=_dr(train_rng, args, 3))
        fv = mlp_encoder(params["factor_v"], v, drop=_dr(train_rng, args, 4))

        def target(x):
            return x.mean(dim=1) if x.ndim == 3 else x

        recon = (
            torch.mean((nn.dense(params["recon_a"], torch.cat([shared, fa], -1))
                        - target(batch["audios"])) ** 2)
            + torch.mean((nn.dense(params["recon_t"], torch.cat([shared, ft], -1))
                          - target(batch["texts"])) ** 2)
            + torch.mean((nn.dense(params["recon_v"], torch.cat([shared, fv], -1))
                          - target(batch["videos"])) ** 2)
        )
        emos, vals = _heads(params["heads"], shared)
        return shared, emos, vals, recon


# -- Attention_TOPN: N-stream attention fusion (attention_topn.py:8-92) ---------


@registry.register_model("toolkit_attention_topn")
class AttentionTopN:
    """Attention fusion over N feature streams (top-N feature-set selection
    experiments); the per-stream encoders are a list, at most 18 streams as
    the reference asserts."""

    @staticmethod
    def _dims(args: FusionArgs) -> Tuple[int, ...]:
        return tuple(args.feat_dims) or (args.audio_dim, args.text_dim, args.video_dim)

    @staticmethod
    def init(g, args: FusionArgs):
        dims = AttentionTopN._dims(args)
        assert len(dims) <= 18, "reference supports at most 18 streams"
        n = len(dims)
        return {
            "encoders": [mlp_encoder_init(g, d, args.hidden_dim) for d in dims],
            "attention_mlp": mlp_encoder_init(g, args.hidden_dim * n, args.hidden_dim),
            "fc_att": nn.dense_init(g, args.hidden_dim, n),
            "heads": _heads_init(g, args.hidden_dim, args),
        }

    @staticmethod
    def apply(params, args: FusionArgs, batch, train_rng=None) -> Tuple:
        if "feat0" in batch:
            streams = [batch[f"feat{i}"] for i in range(len(params["encoders"]))]
        else:  # standard trainer batches: the 3-stream special case
            streams = [batch["audios"], batch["texts"], batch["videos"]]
        enc_rng = _site(train_rng, 0) if args.dropout > 0.0 else None
        hiddens = [
            mlp_encoder(p, x, drop=(
                None if enc_rng is None else (nn.fold_in(enc_rng, i), args.dropout)))
            for i, (p, x) in enumerate(zip(params["encoders"], streams))
        ]
        concat = torch.cat(hiddens, dim=1)
        gate = nn.dense(params["fc_att"], mlp_encoder(
            params["attention_mlp"], concat, drop=_dr(train_rng, args, 1)))
        stacked = torch.stack(hiddens, dim=2)  # [b, h, n]
        feats = torch.einsum("bhm,bm->bh", stacked, gate)
        emos, vals = _heads(params["heads"], feats)
        return feats, emos, vals, _scalar_zero(feats)


FUSION_MODELS: Dict[str, type] = {
    "attention": AttentionFusion,
    "attention_topn": AttentionTopN,
    "tfn": TFN,
    "lmf": LMF,
    "lf_dnn": LFDNN,
    "ef_lstm": EFLSTM,
    "mult": MULT,
    "misa": MISA,
    "mfn": MFN,
    "mmim": MMIM,
    "graph_mfn": GraphMFN,
    "mctn": MCTN,
    "mfm": MFM,
}
