"""Text preprocessing. reference parity:
python/flexflow/keras/preprocessing/text.py (Tokenizer)."""
from __future__ import annotations

from collections import Counter
from typing import List


def text_to_word_sequence(text: str, lower: bool = True) -> List[str]:
    if lower:
        text = text.lower()
    for ch in '!"#$%&()*+,-./:;<=>?@[\\]^_`{|}~\t\n':
        text = text.replace(ch, " ")
    return [w for w in text.split(" ") if w]


class Tokenizer:
    def __init__(self, num_words=None, lower: bool = True, oov_token=None):
        self.num_words = num_words
        self.lower = lower
        self.oov_token = oov_token
        self.word_counts = Counter()
        self.word_index = {}

    def fit_on_texts(self, texts):
        for text in texts:
            self.word_counts.update(text_to_word_sequence(text, self.lower))
        idx = 1
        self.word_index = {}
        if self.oov_token is not None:
            self.word_index[self.oov_token] = idx
            idx += 1
        for word, _ in self.word_counts.most_common():
            self.word_index[word] = idx
            idx += 1

    def texts_to_sequences(self, texts):
        oov = self.word_index.get(self.oov_token) if self.oov_token else None
        out = []
        for text in texts:
            seq = []
            for w in text_to_word_sequence(text, self.lower):
                i = self.word_index.get(w, oov)
                if i is None:
                    continue
                if self.num_words and i >= self.num_words:
                    i = oov
                    if i is None:
                        continue
                seq.append(i)
            out.append(seq)
        return out

    def sequences_to_matrix(self, sequences, mode: str = "binary"):
        """Vectorize integer sequences to a (n, num_words) matrix
        (binary/count/freq/tfidf as in tf.keras)."""
        import math

        import numpy as np

        if not self.num_words:
            raise ValueError("sequences_to_matrix needs num_words")
        n = len(sequences)
        m = np.zeros((n, self.num_words), dtype=np.float64)
        doc_freq: Counter = Counter()
        if mode == "tfidf":  # precompute df once, not per (row, index)
            for seq in sequences:
                doc_freq.update({i for i in seq if 0 <= i < self.num_words})
        for row, seq in enumerate(sequences):
            counts = Counter(i for i in seq if 0 <= i < self.num_words)
            for idx, c in counts.items():
                if mode == "binary":
                    m[row, idx] = 1.0
                elif mode == "count":
                    m[row, idx] = c
                elif mode == "freq":
                    m[row, idx] = c / max(len(seq), 1)
                elif mode == "tfidf":
                    tf = 1.0 + math.log(c)
                    m[row, idx] = tf * math.log(1.0 + n / (1.0 + doc_freq[idx]))
                else:
                    raise ValueError(f"unknown mode {mode}")
        return m
