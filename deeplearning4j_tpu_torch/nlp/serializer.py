"""Word-vector (de)serialization: Google word2vec binary + text formats.

Parity: reference nlp/models/embeddings/loader/WordVectorSerializer.java
(388 LoC): `writeWordVectors`/`loadTxtVectors` (text: "word v1 v2 ...\\n")
and the Google binary format ("V D\\n" header, then per word: "word " +
D float32 little-endian + '\\n').

Host code: the port's own copy of the JAX package's
`nlp/serializer.py`, the same bytes; a table on the device is copied back
first.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from deeplearning4j_tpu_torch.nlp.vocab import VocabCache
from deeplearning4j_tpu_torch.nlp.word2vec import host_array

if TYPE_CHECKING:  # pragma: no cover
    from deeplearning4j_tpu_torch.nlp.word2vec import WordVectors


def save_word_vectors(wv: "WordVectors", path: str,
                      binary: bool = False) -> None:
    vocab, syn0 = wv.vocab, host_array(wv.syn0)
    v, d = syn0.shape
    if binary:
        with open(path, "wb") as f:
            f.write(f"{v} {d}\n".encode())
            for i in range(v):
                f.write(vocab.word_at(i).encode() + b" ")
                f.write(syn0[i].astype("<f4").tobytes())
                f.write(b"\n")
    else:
        with open(path, "w", encoding="utf-8") as f:
            for i in range(v):
                vec = " ".join(f"{x:.6g}" for x in syn0[i])
                f.write(f"{vocab.word_at(i)} {vec}\n")


def load_word_vectors(path: str, binary: bool = False) -> "WordVectors":
    from deeplearning4j_tpu_torch.nlp.word2vec import WordVectors

    cache = VocabCache()
    vectors = []
    if binary:
        with open(path, "rb") as f:
            header = f.readline().split()
            v, d = int(header[0]), int(header[1])
            for _ in range(v):
                word = bytearray()
                while True:
                    ch = f.read(1)
                    if ch in (b" ", b""):
                        break
                    word.extend(ch)
                vec = np.frombuffer(f.read(4 * d), dtype="<f4")
                trailer = f.read(1)  # newline
                if trailer not in (b"\n", b""):
                    raise ValueError("Malformed word2vec binary file")
                w = word.decode("utf-8", errors="replace")
                if cache.contains(w):  # duplicate row: keep the first
                    continue
                cache.add_token(w)
                cache.add_word_to_index(w)
                vectors.append(np.asarray(vec, np.float32))
    else:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split(" ")
                if len(parts) == 2 and all(p.isdigit() for p in parts):
                    continue  # optional "V D" header
                w, vals = parts[0], parts[1:]
                if cache.contains(w):  # duplicate row: keep the first
                    continue
                cache.add_token(w)
                cache.add_word_to_index(w)
                vectors.append(np.asarray([float(x) for x in vals],
                                          np.float32))
    if not vectors:
        raise ValueError(f"No vectors found in {path}")
    return WordVectors(cache, np.stack(vectors))
