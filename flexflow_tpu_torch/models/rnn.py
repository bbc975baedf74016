"""Counterpart of flexflow_tpu/models/rnn.py, the same graph, op names
and defaults. LSTM NMT encoder-decoder (reference: nmt/ — the legacy pre-FFModel
RNN/LSTM neural machine translation app, nmt/rnn.cu, nmt/lstm.cu,
nmt/embed.cu). Rebuilt on the FFModel layer API with the LSTM op
(ops/rnn.py)."""
from __future__ import annotations

from ..ffconst import AggrMode


def build_lstm_nmt(model, src_tokens, tgt_tokens,
                   src_vocab: int = 32000, tgt_vocab: int = 32000,
                   embed_dim: int = 512, hidden_size: int = 512,
                   num_layers: int = 2):
    """Encoder: embed → stacked LSTMs; decoder: embed → stacked LSTMs whose
    first layer is conditioned on the encoder's final state by feature
    concat; projection to target vocab. Returns per-position softmax."""
    ff = model
    enc = ff.embedding(src_tokens, src_vocab, embed_dim,
                       AggrMode.AGGR_MODE_NONE, name="src_emb")
    for i in range(num_layers - 1):
        enc = ff.lstm(enc, hidden_size, name=f"enc_lstm{i}")
    # final encoder layer keeps only its last hidden state — the summary
    summary = ff.lstm(enc, hidden_size, return_sequences=False,
                      name=f"enc_lstm{num_layers - 1}")

    dec = ff.embedding(tgt_tokens, tgt_vocab, embed_dim,
                       AggrMode.AGGR_MODE_NONE, name="tgt_emb")
    # condition decoder on encoder: concat the encoder's (broadcast) summary
    # with each target embedding, as the legacy app's attention-free variant
    b, s = tgt_tokens.dims[0], tgt_tokens.dims[1]
    summary_seq = ff.reshape(summary, [b, 1, hidden_size])
    summary_seq = ff.concat([summary_seq] * s, axis=1)
    dec = ff.concat([dec, summary_seq], axis=-1)
    for i in range(num_layers):
        dec = ff.lstm(dec, hidden_size, name=f"dec_lstm{i}")
    logits = ff.dense(dec, tgt_vocab, name="proj")
    return ff.softmax(logits)
