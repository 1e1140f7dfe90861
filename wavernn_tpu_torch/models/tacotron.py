"""Tacotron (text -> mel) for PyTorch (port of
``wavernn_tpu.models.tacotron``: free-running inference and the training
forward of every mode).

Module and parameter names follow the reference state dict
(models/tacotron.py:289-519), so a reference ``.pyt`` loads with
``load_state_dict(strict=True)``. Generation: the encoder (length-aware
for a padded batch), the whole free-running decoder loop in the decode
kernel B2 (one sentence) or B8 (a batch, a stop per row; ops/cuda_taco.py),
then the postnet CBHG and ``post_proj``; on CUDA the CBHG BiGRUs run on
B5's forward kernel. Training
(``forward``): the CBHG BiGRUs run on the GRU recurrence kernel B5
(ops/cuda_gru.py) and the decoder's group recurrence on kernel B6 (teacher
forcing) or B7 (attention forcing) (ops/cuda_taco_train.py).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..config import TTS_MODES, TacotronConfig
from ..device import resolve_device
from ..ops import layers as L
from ..ops.cuda_taco import decode, decode_batch
from ..ops.cuda_taco_train import (af_operands, core_free_ref,
                                   decoder_af_train, decoder_tf_train,
                                   zoneout_masks)
from ..text.symbols import symbols
from ..timing import stage


class PreNet(nn.Module):
    def __init__(self, in_dims: int, fc1_dims: int = 256, fc2_dims: int = 128):
        super().__init__()
        self.fc1 = nn.Linear(in_dims, fc1_dims)
        self.fc2 = nn.Linear(fc1_dims, fc2_dims)

    def forward(self, x):
        return prenet(x, self.fc1.weight, self.fc1.bias, self.fc2.weight,
                      self.fc2.bias)


def prenet(x, w1, b1, w2, b2, rate: float = 0.5, training: bool = False,
           masks=(None, None)):
    """PreNet: two ReLU layers, each followed by dropout with the scaled
    keep-``masks`` when training; dropout off in eval, as in the
    reference's generate."""
    x = torch.relu(L.linear(x, w1, b1))
    x = L.dropout(x, rate, training, masks[0])
    x = torch.relu(L.linear(x, w2, b2))
    return L.dropout(x, rate, training, masks[1])


class HighwayNetwork(nn.Module):
    def __init__(self, size: int):
        super().__init__()
        self.W1 = nn.Linear(size, size)
        self.W2 = nn.Linear(size, size)

    def forward(self, x):
        x1 = L.linear(x, self.W1.weight, self.W1.bias)
        g = torch.sigmoid(L.linear(x, self.W2.weight, self.W2.bias))
        return g * torch.relu(x1) + (1.0 - g) * x


class BatchNormConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel: int):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, out_channels, kernel, bias=False)
        self.bnorm = nn.BatchNorm1d(out_channels)

    def forward(self, x, relu: bool, training: bool = False):
        """Conv, ReLU, BatchNorm; ``training`` normalises on batch
        statistics (over every output position, the extra one of an even
        kernel width included) and updates the running ones in place."""
        k = self.conv.weight.shape[-1]
        x = L.conv1d(x, self.conv.weight, padding=k // 2)
        if relu:
            x = torch.relu(x)
        b = self.bnorm
        if training:
            return L.batchnorm_train(x, b.weight, b.bias, b.running_mean,
                                     b.running_var,
                                     mesh=getattr(b, "mesh", None))
        return L.batchnorm(x, b.weight, b.bias, b.running_mean,
                           b.running_var)


def _maxpool_k2_s1(x):
    """MaxPool1d(kernel=2, stride=1, padding=1) then [:T] (tacotron.py:68,111)."""
    xp = torch.nn.functional.pad(x, (1, 0), value=-math.inf)
    return torch.maximum(xp[:, :, :-1], xp[:, :, 1:])


class CBHG(nn.Module):
    def __init__(self, K: int, in_channels: int, channels: int,
                 proj_channels, num_highways: int):
        super().__init__()
        self.conv1d_bank = nn.ModuleList(
            BatchNormConv(in_channels, channels, k) for k in range(1, K + 1))
        self.conv_project1 = BatchNormConv(K * channels, proj_channels[0], 3)
        self.conv_project2 = BatchNormConv(proj_channels[0],
                                           proj_channels[1], 3)
        if proj_channels[-1] != channels:
            self.pre_highway = nn.Linear(proj_channels[-1], channels,
                                         bias=False)
        self.highways = nn.ModuleList(HighwayNetwork(channels)
                                      for _ in range(num_highways))
        self.rnn = nn.GRU(channels, channels, batch_first=True,
                          bidirectional=True)

    def forward(self, x, training: bool = False, engine: str = "scan",
                lens: Optional[torch.Tensor] = None):
        """(B, C_in, T) -> (B, T, 2*channels). ``training``: BatchNorm on
        batch statistics, taken before the bank's truncation to T
        (tacotron.py:103-105). ``engine``: the BiGRU's (ops/layers.gru).
        ``lens`` (B,): the true lengths of right-padded rows (generation
        only). Pad positions are re-zeroed at every conv input, after the
        bank's BatchNorm and after the max-pool, and the BiGRU runs
        length-aware, so each row's valid outputs are those of the row run
        alone (cbhg_apply, wavernn_tpu/models/tacotron.py:148-207)."""
        T = x.shape[-1]
        zmask = None
        if lens is not None:
            zmask = (torch.arange(T, device=x.device)[None, None, :]
                     < lens.to(x.device)[:, None, None]).to(x.dtype)
            x = x * zmask
        residual = x
        h = torch.cat([blk(x, True, training)[:, :, :T]
                       for blk in self.conv1d_bank], dim=1)
        if zmask is not None:   # BN(0) != 0: re-zero before pool and conv
            h = h * zmask
        h = _maxpool_k2_s1(h)
        if zmask is not None:
            h = h * zmask
        c = self.conv_project1(h, True, training)
        if zmask is not None:
            c = c * zmask
        c = self.conv_project2(c, False, training)
        h = (c + residual).transpose(1, 2)
        if hasattr(self, "pre_highway"):
            h = L.linear(h, self.pre_highway.weight)
        for hw in self.highways:
            h = hw(h)
        g = self.rnn
        return L.bigru(h, (g.weight_ih_l0, g.weight_hh_l0, g.bias_ih_l0,
                           g.bias_hh_l0),
                       (g.weight_ih_l0_reverse, g.weight_hh_l0_reverse,
                        g.bias_ih_l0_reverse, g.bias_hh_l0_reverse),
                       lens=lens, engine=engine)


class Encoder(nn.Module):
    def __init__(self, tts: TacotronConfig, num_chars: int):
        super().__init__()
        self.embedding = nn.Embedding(num_chars, tts.embed_dims)
        self.pre_net = PreNet(tts.embed_dims)
        self.cbhg = CBHG(tts.encoder_K, tts.encoder_dims, tts.encoder_dims,
                         [tts.encoder_dims, tts.encoder_dims],
                         tts.num_highways)

    def forward(self, ids, training: bool = False, engine: str = "scan",
                rate: float = 0.5, masks=(None, None),
                lens: Optional[torch.Tensor] = None):
        """(B, T_text) ids -> (B, T_text, 2*encoder_dims). ``training``:
        prenet dropout with the scaled keep-``masks`` and the CBHG in
        training mode. ``lens``: see CBHG.forward (batched generation
        encodes each right-padded row as it would alone)."""
        p = self.pre_net
        x = prenet(L.embedding(ids, self.embedding.weight), p.fc1.weight,
                   p.fc1.bias, p.fc2.weight, p.fc2.bias, rate, training,
                   masks)
        return self.cbhg(x.transpose(1, 2), training, engine, lens)


class LSA(nn.Module):
    def __init__(self, attn_dims: int):
        super().__init__()
        self.conv = nn.Conv1d(2, 32, 31, padding=15, bias=False)
        self.L = nn.Linear(32, attn_dims)
        self.W = nn.Linear(attn_dims, attn_dims)
        self.v = nn.Linear(attn_dims, 1, bias=False)


class Decoder(nn.Module):
    def __init__(self, tts: TacotronConfig, n_mels: int):
        super().__init__()
        d = tts.decoder_dims
        self.prenet = PreNet(n_mels)
        self.attn_net = LSA(d)
        self.attn_rnn = nn.GRUCell(d + d // 2, d)
        self.rnn_input = nn.Linear(2 * d, tts.lstm_dims)
        self.res_rnn1 = nn.LSTMCell(tts.lstm_dims, tts.lstm_dims)
        self.res_rnn2 = nn.LSTMCell(tts.lstm_dims, tts.lstm_dims)
        self.mel_proj = nn.Linear(tts.lstm_dims, n_mels * tts.max_r,
                                  bias=False)
        self.register_buffer("r", torch.tensor(1, dtype=torch.int32))


class Tacotron(nn.Module):
    def __init__(self, tts: TacotronConfig, n_mels: int = 80,
                 num_chars: int = len(symbols)):
        super().__init__()
        self.tts, self.n_mels = tts, n_mels
        d = tts.decoder_dims
        self.encoder = Encoder(tts, num_chars)
        self.encoder_proj = nn.Linear(d, d, bias=False)
        self.decoder = Decoder(tts, n_mels)
        self.postnet = CBHG(tts.postnet_K, n_mels, tts.postnet_dims,
                            [256, n_mels], tts.num_highways)
        self.post_proj = nn.Linear(2 * tts.postnet_dims, n_mels, bias=False)
        self.register_buffer("step", torch.zeros(1, dtype=torch.long))
        self.register_buffer("stop_threshold",
                             torch.tensor(tts.stop_threshold,
                                          dtype=torch.float32))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Fresh weights from ``generator`` with the JAX package's init:
        xavier-uniform on every matrix (reference init_model,
        tacotron.py:482-484), biases U(+-1/sqrt(fan_in)), highway W1 biases
        zero, BatchNorm at identity."""
        def uniform(p, bound):
            p.copy_(torch.rand(p.shape, generator=generator) * 2 * bound
                    - bound)

        for name, p in self.named_parameters():
            mod_name, leaf = name.rsplit(".", 1)
            mod = self.get_submodule(mod_name)
            if isinstance(mod, nn.BatchNorm1d):
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif p.dim() > 1:
                rf = math.prod(p.shape[2:])
                uniform(p, math.sqrt(6.0 / (p.shape[1] * rf + p.shape[0] * rf)))
            elif mod_name.endswith(".W1"):  # highway (tacotron.py:15)
                p.zero_()
            elif isinstance(mod, (nn.GRU, nn.GRUCell, nn.LSTMCell)):
                uniform(p, 1.0 / math.sqrt(mod.hidden_size))
            else:
                uniform(p, 1.0 / math.sqrt(mod.weight.shape[1]))
        for m in self.modules():
            if isinstance(m, nn.BatchNorm1d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)

    def decoder_parameters(self):
        """The decoder's parameters by state-dict name below ``decoder.``,
        attached to autograd."""
        return dict(self.decoder.named_parameters())

    def decoder_weights(self):
        """The decoder's weights by state-dict name below ``decoder.``."""
        return {k: v.detach() for k, v in self.decoder.named_parameters()}


# --------------------------------------------------------------------------
# decoder math on weight dicts (shared with the plain decode)
# --------------------------------------------------------------------------

def lsa_scores(dec, encoder_seq_proj, query, cumulative, attention,
               text_mask=None):
    """Location-sensitive smooth attention (tacotron.py:187-205): sigmoid
    energies normalised by their sum over the text. Returns (B, T_text)."""
    q = L.linear(query, dec["attn_net.W.weight"],
                 dec["attn_net.W.bias"])[:, None, :]
    loc = torch.stack([cumulative, attention], dim=1)
    loc = L.conv1d(loc, dec["attn_net.conv.weight"], padding=15)
    loc = L.linear(loc.transpose(1, 2), dec["attn_net.L.weight"],
                   dec["attn_net.L.bias"])
    u = L.linear(torch.tanh(q + encoder_seq_proj + loc),
                 dec["attn_net.v.weight"])[..., 0]
    sig = torch.sigmoid(u)
    if text_mask is not None:
        sig = sig * text_mask
    return sig / torch.sum(sig, dim=1, keepdim=True)


class DecoderState(NamedTuple):
    attn_hidden: torch.Tensor
    rnn1_h: torch.Tensor
    rnn1_c: torch.Tensor
    rnn2_h: torch.Tensor
    rnn2_c: torch.Tensor
    context: torch.Tensor
    cumulative: torch.Tensor
    attention: torch.Tensor
    prev_frame: torch.Tensor  # last mel frame of the previous group


def init_decoder_state(dec, batch: int, T_text: int, n_mels: int,
                       device) -> DecoderState:
    d = dec["attn_rnn.weight_hh"].shape[1]
    lstm = dec["res_rnn1.weight_hh"].shape[1]
    E = dec["rnn_input.weight"].shape[1] - d
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return DecoderState(z(batch, d), z(batch, lstm), z(batch, lstm),
                        z(batch, lstm), z(batch, lstm), z(batch, E),
                        z(batch, T_text), z(batch, T_text), z(batch, n_mels))


def decoder_step(dec, encoder_seq, encoder_seq_proj, prenet_in,
                 state: DecoderState, r: int, n_mels: int, max_r: int,
                 text_mask=None):
    """One free-running decoder group (tacotron.py:229-286, eval).
    Returns (mels (B, n_mels, r), scores (B, T_text), new_state)."""
    p = prenet(prenet_in, dec["prenet.fc1.weight"], dec["prenet.fc1.bias"],
               dec["prenet.fc2.weight"], dec["prenet.fc2.bias"])
    attn_hidden = L.gru_cell(torch.cat([state.context, p], dim=-1),
                             state.attn_hidden, dec["attn_rnn.weight_ih"],
                             dec["attn_rnn.weight_hh"],
                             dec["attn_rnn.bias_ih"], dec["attn_rnn.bias_hh"])
    scores = lsa_scores(dec, encoder_seq_proj, attn_hidden, state.cumulative,
                        state.attention, text_mask)
    cumulative = state.cumulative + scores
    context = torch.einsum("bt,btc->bc", scores, encoder_seq)
    x = L.linear(torch.cat([context, attn_hidden], dim=1),
                 dec["rnn_input.weight"], dec["rnn_input.bias"])
    h1, c1 = L.lstm_cell(x, (state.rnn1_h, state.rnn1_c),
                         dec["res_rnn1.weight_ih"], dec["res_rnn1.weight_hh"],
                         dec["res_rnn1.bias_ih"], dec["res_rnn1.bias_hh"])
    x = x + h1
    h2, c2 = L.lstm_cell(x, (state.rnn2_h, state.rnn2_c),
                         dec["res_rnn2.weight_ih"], dec["res_rnn2.weight_hh"],
                         dec["res_rnn2.bias_ih"], dec["res_rnn2.bias_hh"])
    x = x + h2
    mels = L.linear(x, dec["mel_proj.weight"])
    mels = mels.reshape(x.shape[0], n_mels, max_r)[:, :, :r]
    new_state = DecoderState(attn_hidden, h1, c1, h2, c2, context,
                             cumulative, scores, mels[:, :, -1])
    return mels, scores, new_state


def postnet(model: Tacotron, mel, training: bool = False,
            engine: str = "scan"):
    """(B, n_mels, steps) -> linear (B, n_mels, steps)."""
    y = model.postnet(mel, training, engine)
    return L.linear(y, model.post_proj.weight).transpose(1, 2)


MASK_NAMES = ("enc_drop1", "enc_drop2", "dec_drop1", "dec_drop2", "zm1",
              "zm2")


def draw_masks(model: Tacotron, B: int, T_text: int, n_groups: int,
               generator: torch.Generator, device) -> dict:
    """The random draws of one training forward, by ``MASK_NAMES``: the
    encoder prenet's dropout keep-masks (B, T_text, P1), (B, T_text, P2)
    and the decoder prenet's (G, B, P1), (G, B, P2), scaled by
    1 / (1 - dropout); the zoneout keep-previous masks (G, B, lstm_dims) of
    0/1, drawn from ``generator`` on ``device``."""
    tts = model.tts
    P1 = model.decoder.prenet.fc1.weight.shape[0]
    P2 = model.decoder.prenet.fc2.weight.shape[0]
    drop = lambda *shape: L.dropout_mask(shape, tts.dropout, generator,
                                         device)
    zm1, zm2 = zoneout_masks(n_groups, B, tts.lstm_dims, generator, device)
    return {"enc_drop1": drop(B, T_text, P1), "enc_drop2": drop(B, T_text, P2),
            "dec_drop1": drop(n_groups, B, P1),
            "dec_drop2": drop(n_groups, B, P2), "zm1": zm1, "zm2": zm2}


class _Forward(nn.Module):
    """``forward`` as a module call, so that ``torch.func.functional_call``
    can run it on the model's parameters cast to a compute dtype."""

    def __init__(self, model: Tacotron):
        super().__init__()
        self.model = model

    def forward(self, *args, **kwargs):
        return forward(self.model, *args, **kwargs)


def _cast_params_except_bn(model: Tacotron, dtype) -> dict:
    """Every parameter cast to ``dtype`` (a differentiable cast, so the
    gradients reach the float32 masters in float32), except BatchNorm's,
    which stay float32 with its running statistics
    (``_cast_params_except_bn``, wavernn_tpu/models/tacotron.py:338-348)."""
    bn = {name for name, mod in model.named_modules()
          if isinstance(mod, nn.BatchNorm1d)}
    return {"model." + k: (p if k.rsplit(".", 1)[0] in bn else p.to(dtype))
            for k, p in model.named_parameters()}


def forward(model: Tacotron, x_ids, m, r: int,
            mode: str = "teacher_forcing", training: bool = True,
            generate_gta: bool = False, recurrence: str = "auto",
            masks: Optional[dict] = None,
            generator: Optional[torch.Generator] = None,
            attn_ref: Optional[torch.Tensor] = None,
            decoder_only: bool = False, compute_dtype=None):
    """Training forward of every mode (tacotron.py:319-379; the JAX
    package's ``models/tacotron.forward``).

    x_ids (B, T_text); m (B, n_mels, steps) target mels, steps % r == 0.
    Returns (mel_out (B, n_mels, steps), linear (B, n_mels, steps), attn
    (B, steps // r, T_text)). ``mode``: "teacher_forcing" feeds group g > 0
    the ground-truth frame m[:, :, g*r - 1]; "attention_forcing_online" /
    "attention_forcing_offline" feed the decoder's own previous frame and
    weight the context by ``attn_ref`` (B, steps // r, T_text);
    "free_running" feeds its own frame and weights the context by its own
    scores. ``training`` applies the two encoder-prenet and the two
    decoder-prenet dropouts and zoneout, runs BatchNorm on batch statistics
    and updates its running statistics in place; their random draws are
    ``masks`` (``draw_masks``' dict, injected) or drawn from ``generator``.
    ``generate_gta`` forces eval mode (no dropout, zoneout off, running
    statistics). ``decoder_only`` skips the postnet (linear is None).
    ``recurrence``: "auto"/"pallas" run the CBHG BiGRUs on B5 and the
    decoder recurrence on B6 (teacher forcing) or B7 (attention forcing),
    their plain versions on CPU tensors; "scan" runs the plain step loops
    under autograd. Free running has no kernel: its loop is plain on every
    device.

    ``compute_dtype`` (torch.bfloat16): mixed precision as the JAX
    package's (wavernn_tpu/models/tacotron.py:356-376, :494-498): the
    forward runs on every parameter cast to it except BatchNorm's, on m and
    attn_ref cast to it, and returns mel, linear and attn in float32; the
    master parameters stay float32 and take float32 gradients through the
    casts. The kernels (B5, B6, B7) then run on bfloat16 operands."""
    if compute_dtype is not None and compute_dtype != torch.float32:
        outs = torch.func.functional_call(
            _Forward(model), _cast_params_except_bn(model, compute_dtype),
            (x_ids, m.to(compute_dtype), r),
            dict(mode=mode, training=training, generate_gta=generate_gta,
                 recurrence=recurrence, masks=masks, generator=generator,
                 attn_ref=(None if attn_ref is None
                           else attn_ref.to(compute_dtype)),
                 decoder_only=decoder_only))
        return tuple(None if t is None else t.float() for t in outs)
    if mode not in TTS_MODES:
        raise ValueError(f"unknown mode {mode!r}: one of {TTS_MODES}")
    if recurrence not in ("auto", "pallas", "scan"):
        raise ValueError(f"unknown recurrence {recurrence!r}")
    af = mode.startswith("attention_forcing")
    if af and attn_ref is None:
        raise ValueError(f"mode {mode!r} needs attn_ref (B, steps // r, "
                         "T_text)")
    if generate_gta:
        training = False
    tts, n_mels = model.tts, model.n_mels
    B, _, steps = m.shape
    G = steps // r
    engine = "scan" if recurrence == "scan" else "kernel"
    dec = model.decoder_parameters()
    if training and masks is None:
        masks = draw_masks(model, B, x_ids.shape[1], G, generator, m.device)
    mk = (lambda name: masks[name]) if training else (lambda name: None)

    encoder_seq = model.encoder(x_ids, training, engine, tts.dropout,
                                (mk("enc_drop1"), mk("enc_drop2")))
    encoder_seq_proj = L.linear(encoder_seq, model.encoder_proj.weight)
    if training:
        zm1, zm2 = masks["zm1"], masks["zm2"]
    else:
        zm1 = zm2 = m.new_zeros(G, B, tts.lstm_dims)

    if mode == "teacher_forcing":
        # group g > 0 is fed the ground-truth frame m[:, :, g*r - 1]; group
        # 0 the GO frame. The prenet is hoisted over all G*B rows.
        tf_in = torch.cat([m.new_zeros(B, n_mels, 1),
                           m[:, :, r - 1::r][:, :, :-1]], dim=2)
        dec_masks = tuple(None if t is None else t.reshape(G * B, -1)
                          for t in (mk("dec_drop1"), mk("dec_drop2")))
        pre_all = prenet(tf_in.permute(2, 0, 1).reshape(G * B, n_mels),
                         dec["prenet.fc1.weight"], dec["prenet.fc1.bias"],
                         dec["prenet.fc2.weight"], dec["prenet.fc2.bias"],
                         tts.dropout, training, dec_masks).reshape(G, B, -1)
        mel_groups, attn_scores = decoder_tf_train(
            dec, encoder_seq, encoder_seq_proj, pre_all, zm1, zm2, tts.max_r,
            r, n_mels, impl=engine)
    else:
        # the prenet runs inside the recurrence on the previous group's
        # last frame, with the decoder prenet's dropout masks per group
        if training:
            dm1, dm2 = masks["dec_drop1"], masks["dec_drop2"]
        else:
            P1 = dec["prenet.fc1.weight"].shape[0]
            P2 = dec["prenet.fc2.weight"].shape[0]
            dm1, dm2 = m.new_ones(G, B, P1), m.new_ones(G, B, P2)
        if af:
            mel_groups, attn_scores = decoder_af_train(
                dec, encoder_seq, encoder_seq_proj, attn_ref, dm1, dm2, zm1,
                zm2, tts.max_r, r, n_mels, impl=engine)
        else:
            mel, attn_scores = core_free_ref(
                dm1, dm2, zm1.to(m.dtype), zm2.to(m.dtype), encoder_seq,
                encoder_seq_proj, *af_operands(dec, tts.max_r, r, n_mels))
            mel_groups = mel.reshape(G, B, r, n_mels).transpose(2, 3)

    mel_out = mel_groups.permute(1, 2, 0, 3).reshape(B, n_mels, steps)
    attn = attn_scores.transpose(0, 1)
    if decoder_only:
        return mel_out, None, attn
    linear = postnet(model, mel_out, training, engine)
    return mel_out, linear, attn


@torch.no_grad()
def generate_core(model: Tacotron, ids, lens=None, r: int = 2,
                  steps: int = 2000, timings: Optional[dict] = None):
    """The device half of free-running generation (``_generate_kernel`` and
    ``_generate_kernel_batch``, wavernn_tpu/models/tacotron.py:609-696):
    ids (B, T_text) on the model's device, right-padded to the longest of
    ``lens``. One row (no ``lens``) runs the decode kernel B2; a batch the
    length-aware encoder, pad positions of its outputs zeroed, and the
    batched kernel B8 under the rows' text mask. Then the postnet over every
    group. Returns (mel (B, n_mels, steps), linear (B, n_mels, steps),
    attn (B, steps // r, T_text), n_valid (B,)) on the device."""
    tts, n_mels = model.tts, model.n_mels
    dev = ids.device
    # the CBHG BiGRUs: B5's forward kernel on CUDA, the plain loop on the CPU
    eng = "kernel" if dev.type == "cuda" else "scan"
    T = ids.shape[1]
    with stage(timings, "encoder", dev):
        enc = model.encoder(ids, engine=eng, lens=lens)
        encp = L.linear(enc, model.encoder_proj.weight)
        if lens is not None:
            mask = (torch.arange(T, device=dev)[None, :]
                    < lens.to(dev)[:, None]).to(torch.float32)
            # the length-aware encoder's pad positions hold garbage: zero
            # them so the masked attention sees clean context planes
            enc = enc * mask[..., None]
            encp = encp * mask[..., None]
    with stage(timings, "decode_kernel", dev):
        args = (model.decoder_weights(), enc, encp)
        tail = (r, steps, n_mels, tts.max_r, tts.stop_threshold)
        if lens is None:
            mel, attn, n_valid = decode(
                *args, torch.ones(T, dtype=torch.float32, device=dev), *tail)
        else:
            mel, attn, n_valid = decode_batch(*args, mask, *tail)
    with stage(timings, "postnet", dev):
        linear = postnet(model, mel, engine=eng)
    return mel, linear, attn, n_valid


@torch.no_grad()
def generate(model: Tacotron, x_ids, r: int, steps: int = 2000,
             device="cuda", timings: Optional[dict] = None):
    """Free-running inference (tacotron.py:420-480): batch-1 text ids ->
    (mel (n_mels, T), linear (n_mels, T), attn (T // r, T_text)) as numpy,
    trimmed after the group that triggered the stop."""
    dev = resolve_device(device, model)
    steps = -(-steps // r) * r
    ids = torch.as_tensor(np.asarray(x_ids), dtype=torch.long,
                          device=dev)[None]
    mel, linear, attn, n_valid = generate_core(model, ids, None, r, steps,
                                               timings)
    T = min(int(n_valid[0]) * r, steps)
    return (mel[0, :, :T].cpu().numpy(), linear[0, :, :T].cpu().numpy(),
            attn[0, :T // r].cpu().numpy())


def pad_ids(x_ids_list, device):
    """Right-pad a list of id sequences: (ids (B, T_max), lens (B,))."""
    lens = [len(x) for x in x_ids_list]
    ids = np.zeros((len(lens), max(lens)), np.int64)
    for i, x in enumerate(x_ids_list):
        ids[i, :lens[i]] = np.asarray(x)
    return (torch.as_tensor(ids, device=device),
            torch.as_tensor(lens, dtype=torch.long, device=device))


@torch.no_grad()
def generate_batch(model: Tacotron, x_ids_list, r: int, steps: int = 2000,
                   device="cuda", timings: Optional[dict] = None):
    """Free-running decode of a batch of sentences (``generate_batch``,
    wavernn_tpu/models/tacotron.py:699-742): the text right-padded to the
    longest, masked out of the smooth attention's normalisation, each
    utterance with its own stop. One sentence runs ``generate``'s path (B2,
    no padding). Returns a list of numpy (mel, linear, attn) triples, each
    trimmed after its own stop group (attn to its own text)."""
    dev = resolve_device(device, model)
    steps = -(-steps // r) * r
    ids, lens = pad_ids(x_ids_list, dev)
    mel, linear, attn, n_valid = generate_core(
        model, ids, lens if len(x_ids_list) > 1 else None, r, steps, timings)
    n_valid = n_valid.cpu().tolist()
    outs = []
    for b, x in enumerate(x_ids_list):
        T = min(n_valid[b] * r, steps)
        outs.append((mel[b, :, :T].cpu().numpy(),
                     linear[b, :, :T].cpu().numpy(),
                     attn[b, :T // r, :len(x)].cpu().numpy()))
    return outs
