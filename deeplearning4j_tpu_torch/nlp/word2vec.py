"""Word2Vec: skip-gram with hierarchical softmax and negative sampling.

Parity: reference nlp/models/word2vec/Word2Vec.java (fit :101, buildVocab
:257, trainSentence :298, skipGram :314, iterate :337, lr decay by words
seen :191-296) + InMemoryLookupTable.java (syn0/syn1/syn1Neg, unigram
table resetWeights :88, iterateSample :188-260) + WordVectorsImpl
(similarity / wordsNearest). The port's counterpart of the JAX package's
`nlp/word2vec.py`.

Design: the reference's hot loop does ONE (dot, sigmoid, axpy) at a time
per (center, context, code-bit), racing hogwild threads over shared
syn0/syn1. Here the host mines (center, context) pairs with the JAX
package's numpy code and seeds, so the pairs are identical, and the
device holds syn0 and syn1 / syn1neg as float32 tensors. One batch is
one step on the device:

    HS:  BCE over dot(syn0[context], syn1[points]) against (1 - codes)
    NEG: BCE over dot(syn0[context], syn1neg[target|negatives])

with the JAX package's split loss: the syn0 side weighted by
1 / (pairs touching the row), the syn1 / syn1neg side by
mask / max(pairs touching the row, 1), each side's gradient stopped at
the other table. The gradients are written out (dBCE/dz = sigmoid(z) -
label, and -label at z == 0 exactly, as JAX's autodiff gives), summed per row by `index_add_` into the same dense gradient
JAX's `value_and_grad` gives, and applied as `t - alpha * g`: rows that
no pair touches do not move. On the card the scatter sums through
atomics, so card against CPU agrees to a tolerance, not bit for bit.

Randomness: JAX's `jax.random` streams are not reproducible in torch.
syn0 starts uniform in +-0.5/dim from a `torch.Generator` seeded by
`seed`, drawn on the CPU and moved, so the card and the CPU start equal;
negatives are `table[randint]` through the 2^20-entry unigram^0.75 table,
drawn by a generator on the device (no host round trip a batch). Every
step and `train_pairs` also take the negatives as an argument.

A chunk of `chunk_batches` steps reads nothing back from the device: the
loss stays a device tensor (computed on a chunk's last batch, the one
JAX's scan returns), alpha is a host float, and `fit` makes its one read
at the end.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import default_device
from deeplearning4j_tpu_torch.nlp.huffman import build_huffman, max_code_length
from deeplearning4j_tpu_torch.nlp.sentence_iterator import (
    CollectionSentenceIterator,
    SentenceIterator,
)
from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory,
    TokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, build_vocab

log = logging.getLogger(__name__)


def _prefetch(iterator, depth: int = 2):
    """Run a chunk producer in a background thread so host-side pair
    mining overlaps device training (the reference overlaps via its
    parallel sentence-training threads, Word2Vec.java:191). Exceptions
    propagate to the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _DONE, _ERR = object(), object()

    def produce():
        try:
            for item in iterator:
                q.put(item)
            q.put(_DONE)
        except BaseException as e:  # noqa: BLE001 — relay to consumer
            q.put((_ERR, e))

    t = threading.Thread(target=produce, name="w2v-miner", daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _DONE:
            return
        if isinstance(item, tuple) and len(item) == 2 and item[0] is _ERR:
            raise item[1]
        yield item


def host_array(x) -> np.ndarray:
    """A table (numpy array or tensor on any device) as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def read_back(table: torch.Tensor, loss: Optional[torch.Tensor]
              ) -> Tuple[np.ndarray, float]:
    """A device table and a 0-d loss in ONE device-to-host copy: the
    table as numpy, the loss as a float (nan when there is none)."""
    flat = table.detach().reshape(-1)
    if loss is not None:
        flat = torch.cat([flat, loss.detach().reshape(1).to(flat.dtype)])
    host = flat.cpu().numpy()
    n = table.numel()
    return (host[:n].reshape(tuple(table.shape)),
            float(host[n]) if loss is not None else float("nan"))


class WordVectors:
    """Similarity / nearest-words API over the learned table
    (reference WordVectorsImpl.java). Host numpy, as in the JAX package."""

    def __init__(self, cache: VocabCache, syn0):
        self.vocab = cache
        self.syn0 = host_array(syn0)
        norms = np.linalg.norm(self.syn0, axis=1, keepdims=True)
        self._unit = self.syn0 / np.maximum(norms, 1e-12)

    def _require_fitted(self) -> None:
        if getattr(self, "syn0", None) is None \
                or getattr(self, "_unit", None) is None:
            raise RuntimeError(
                f"{type(self).__name__} has no trained vectors yet — "
                "call fit() first")

    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        self._require_fitted()
        i = self.vocab.index_of(word)
        return self.syn0[i] if i >= 0 else None

    def has_word(self, word: str) -> bool:
        return self.vocab.index_of(word) >= 0

    def similarity(self, w1: str, w2: str) -> float:
        self._require_fitted()
        i, j = self.vocab.index_of(w1), self.vocab.index_of(w2)
        if i < 0 or j < 0:
            return float("nan")
        return float(self._unit[i] @ self._unit[j])

    def words_nearest(self, word: str, n: int = 10) -> List[Tuple[str, float]]:
        self._require_fitted()
        i = self.vocab.index_of(word)
        if i < 0:
            return []
        sims = self._unit @ self._unit[i]
        order = np.argsort(-sims)
        out = []
        for j in order:
            if j == i:
                continue
            out.append((self.vocab.word_at(int(j)), float(sims[j])))
            if len(out) >= n:
                break
        return out


def _bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.clamp_min(0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def _bce_grad(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """d _bce / d logits as JAX's autodiff of the same expression gives
    it: sigmoid(z) - label wherever z != 0. At z == 0 exactly (every
    product with a zero-initialised syn1 / syn1neg row) `maximum` splits
    its subgradient 0.5 / 0.5 while `abs` takes +1, so JAX gives -label
    there, not 0.5 - label; the port follows JAX."""
    return torch.where(logits == 0, -labels, torch.sigmoid(logits) - labels)


class SkipGramStep:
    """One batch of skip-gram training, in place on the device tables.

    Built once per vocab: the Huffman codes / points / mask (V, L) and the
    unigram table live on the device. `__call__(tables, centers,
    contexts, negs, alpha, with_loss)` takes int64 index tensors on the
    tables' device (`negs` (B, negative), or (B, 0) for HS) and a host
    float alpha; it returns the batch loss as a 0-d device tensor when
    `with_loss`, else None. Nothing in it reads from the device."""

    def __init__(self, model: "Word2Vec"):
        dev = model.device
        codes, points, mask = model._codes_points()
        self.negative = model.negative
        self.hs_labels = torch.from_numpy(1.0 - codes).to(dev)
        self.points = torch.from_numpy(points).to(dev, torch.int64)
        self.mask = torch.from_numpy(mask).to(dev)
        self.uni_table = (torch.from_numpy(model._unigram_table()).to(
            dev, torch.int64) if self.negative > 0 else None)

    def draw(self, n: int, gen: torch.Generator) -> torch.Tensor:
        """(n, negative) negatives: unigram-table entries at uniform
        draws from `gen` (on the tables' device)."""
        if self.negative <= 0:
            return torch.zeros((n, 0), dtype=torch.int64,
                               device=self.points.device)
        draws = torch.randint(0, self.uni_table.shape[0],
                              (n, self.negative), generator=gen,
                              device=self.uni_table.device)
        return self.uni_table[draws]

    @staticmethod
    def _side(table, l1, w, tgt, labels, valid, with_loss):
        """One output table's share: the gradient on l1 (syn0 side), the
        per-row gradient on `table[tgt]` (this side), and the loss."""
        rows = table[tgt]                                   # (B, K, D)
        z = torch.bmm(rows, l1.unsqueeze(2)).squeeze(2)     # (B, K)
        hits = torch.zeros(table.shape[0], dtype=table.dtype,
                           device=table.device)
        hits.index_add_(0, tgt.reshape(-1), valid.reshape(-1))
        u = valid / hits[tgt].clamp_min(1.0)
        e = _bce_grad(z, labels)
        a0 = w.unsqueeze(1) * e * valid
        g_l1 = torch.bmm(a0.unsqueeze(1), rows).squeeze(1)  # (B, D)
        g_rows = (u * e * valid).unsqueeze(2) * l1.unsqueeze(1)
        loss = None
        if with_loss:
            loss = ((w.unsqueeze(1) * valid + u * valid)
                    * _bce(z, labels)).sum()
        return g_l1, g_rows, loss

    def __call__(self, tables: Dict[str, torch.Tensor],
                 centers: torch.Tensor, contexts: torch.Tensor,
                 negs: torch.Tensor, alpha: float,
                 with_loss: bool = False) -> Optional[torch.Tensor]:
        syn0 = tables["syn0"]
        l1 = syn0[contexts]                                 # (B, D)
        counts = torch.zeros(syn0.shape[0], dtype=syn0.dtype,
                             device=syn0.device)
        counts.index_add_(0, contexts, torch.ones_like(l1[:, 0]))
        w = 1.0 / counts[contexts]                          # (B,)
        g_l1 = None
        loss = None
        updates = []
        if "syn1" in tables:
            # hierarchical softmax over the center word's code path
            tgt = self.points[centers]
            g, g_rows, ls = self._side(tables["syn1"], l1, w, tgt,
                                       self.hs_labels[centers],
                                       self.mask[centers], with_loss)
            g_l1, loss = g, ls
            updates.append((tables["syn1"], tgt, g_rows))
        if "syn1neg" in tables:
            c = centers.unsqueeze(1)
            tgt = torch.cat([c, negs], dim=1)
            labels = torch.zeros(tgt.shape, dtype=syn0.dtype,
                                 device=syn0.device)
            labels[:, 0] = 1.0
            # mask negatives that drew the positive target itself
            # (reference: `if (target == word) continue`)
            valid = torch.cat([torch.ones_like(labels[:, :1]),
                               (negs != c).to(syn0.dtype)], dim=1)
            g, g_rows, ls = self._side(tables["syn1neg"], l1, w, tgt,
                                       labels, valid, with_loss)
            g_l1 = g if g_l1 is None else g_l1 + g
            if with_loss:
                loss = ls if loss is None else loss + ls
            updates.append((tables["syn1neg"], tgt, g_rows))
        # every gradient is taken from the tables as they were: update
        # last, each as JAX's `t - alpha * g` of the dense summed gradient
        # (summing into the table itself would round at its magnitude)
        for table, tgt, g_rows in updates:
            g = torch.zeros_like(table).index_add_(
                0, tgt.reshape(-1), g_rows.reshape(-1, table.shape[1]))
            table.sub_(g.mul_(alpha))
        if g_l1 is not None:
            g = torch.zeros_like(syn0).index_add_(0, contexts, g_l1)
            syn0.sub_(g.mul_(alpha))
        return loss


class Word2Vec(WordVectors):
    """Skip-gram trainer (builder-style kwargs mirror the reference's
    Word2Vec.Builder: layerSize/windowSize/minWordFrequency/iterations/
    learningRate/minLearningRate/negativeSample/sample/seed). `device`
    (None = the card, raising without one) holds the tables."""

    def __init__(self, sentences=None, *, layer_size: int = 100,
                 window: int = 5, min_word_frequency: float = 1.0,
                 iterations: int = 1, learning_rate: float = 0.025,
                 min_learning_rate: float = 1e-4, negative: int = 0,
                 sample: float = 0.0, batch_pairs: int = 4096,
                 chunk_batches: int = 32, seed: int = 123,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 device=None):
        self.device = default_device(device)
        self.layer_size = layer_size
        self.window = window
        self.min_word_frequency = min_word_frequency
        self.iterations = iterations
        self.alpha = learning_rate
        self.min_alpha = min_learning_rate
        self.negative = negative
        self.sample = sample
        self.batch_pairs = batch_pairs
        self.chunk_batches = chunk_batches  # batches between host reads
        self.seed = seed
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        if isinstance(sentences, SentenceIterator):
            self.sentence_iter = sentences
        elif sentences is not None:
            self.sentence_iter = CollectionSentenceIterator(list(sentences))
        else:
            self.sentence_iter = None
        self.vocab = VocabCache()
        self.syn0 = None
        self.syn1 = None
        self.syn1neg = None
        self._code_len = 0
        self.pairs_trained = 0
        self.last_loss: Optional[torch.Tensor] = None  # 0-d, on device
        self._step_cache: Optional[SkipGramStep] = None
        self._init_gen = torch.Generator().manual_seed(seed)
        self._neg_gen = torch.Generator(device=self.device).manual_seed(seed)

    # ----------------------------------------------------------- vocab/init
    def build_vocab(self) -> None:
        """reference buildVocab :257 + Huffman(vocab).build() :348."""
        build_vocab(self.sentence_iter, self.tokenizer_factory,
                    self.min_word_frequency, self.vocab)
        self._extend_vocab()  # hook: subclasses add pseudo-words (labels)
        build_huffman(self.vocab)
        self._code_len = max(1, max_code_length(self.vocab))
        self._step_cache = None  # vocab-dependent shapes changed

    def _extend_vocab(self) -> None:
        pass

    def reset_weights(self) -> None:
        """reference InMemoryLookupTable.resetWeights :88: syn0 uniform in
        +-0.5/dim (drawn on the CPU, then moved), syn1 zeros."""
        n, d = self.vocab.num_words(), self.layer_size
        u = torch.rand((n, d), generator=self._init_gen, dtype=torch.float32)
        self.syn0 = (u * (1.0 / d) - 0.5 / d).to(self.device)
        zeros = torch.zeros((n, d), dtype=torch.float32, device=self.device)
        if self.negative > 0:
            self.syn1neg = zeros
        else:  # hierarchical softmax path
            self.syn1 = zeros

    UNIGRAM_TABLE_SIZE = 1 << 20

    def _unigram_table(self) -> np.ndarray:
        """unigram^0.75 sampling table (the reference's unigram table,
        InMemoryLookupTable's `table` — 1e8 entries there, 2^20 here):
        table[i] = word index owning cdf bucket i, so drawing a negative
        is ONE random int + ONE gather. Quantization at 2^-20 granularity
        matches the reference's quantized table. Host numpy (int64), the
        JAX package's table entry for entry."""
        counts = np.array([vw.count for vw in self.vocab.vocab_words()],
                          np.float64)
        probs = counts ** 0.75
        probs /= probs.sum()
        cdf = np.cumsum(probs)
        t = self.UNIGRAM_TABLE_SIZE
        # bucket midpoints -> owning word index
        table = np.searchsorted(cdf, (np.arange(t) + 0.5) / t)
        return np.minimum(table, len(cdf) - 1).astype(np.int64)

    # ------------------------------------------------------------- training
    def _codes_points(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Pad per-word Huffman codes/points to (V, L) with a mask."""
        v, L = self.vocab.num_words(), self._code_len
        codes = np.zeros((v, L), np.float32)
        points = np.zeros((v, L), np.int32)
        mask = np.zeros((v, L), np.float32)
        for vw in self.vocab.vocab_words():
            ln = vw.code_length()
            codes[vw.index, :ln] = vw.codes
            points[vw.index, :ln] = vw.points
            mask[vw.index, :ln] = 1.0
        return codes, points, mask

    def _keep_probs(self) -> np.ndarray:
        """Per-vocab-index subsampling keep probability (reference
        trainSentence's frequent-word subsampling, vectorized as a table)."""
        total = max(1.0, self.vocab.total_word_count)
        counts = np.array([vw.count for vw in self.vocab.vocab_words()],
                          np.float64)
        f = np.maximum(counts, 1.0) / total
        keep = (np.sqrt(f / self.sample) + 1.0) * self.sample / f
        return np.minimum(keep, 1.0)

    def _tokens_to_indices(self, sentence: str) -> np.ndarray:
        toks = self.tokenizer_factory.tokenize(sentence)
        idx = np.fromiter((self.vocab.index_of(t) for t in toks),
                          np.int32, count=len(toks))
        return idx[idx >= 0]

    @staticmethod
    def _window_pairs(idx: np.ndarray, sid: np.ndarray, window: int,
                      rng: np.random.RandomState
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized skip-gram windowing over concatenated sentences.

        `idx` holds vocab indices, `sid` the sentence id of each position.
        For every offset 1..window, pairs (center@i, context@i±off) are
        kept when both positions share a sentence and off <= b[i], where b
        is the per-center random window shrink (reference skipGram :314's
        `b = random % window` semantics) — no Python per-token loop.
        """
        n = idx.size
        if n == 0:
            return (np.empty(0, np.int32),) * 2
        b = rng.randint(1, window + 1, size=n)
        cs, xs = [], []
        for off in range(1, window + 1):
            if off >= n:
                break
            same = sid[off:] == sid[:-off]
            m = same & (b[off:] >= off)      # context BEFORE center
            cs.append(idx[off:][m])
            xs.append(idx[:-off][m])
            m = same & (b[:-off] >= off)     # context AFTER center
            cs.append(idx[:-off][m])
            xs.append(idx[off:][m])
        return np.concatenate(cs), np.concatenate(xs)

    def _iter_pair_chunks(self, rng: np.random.RandomState,
                          chunk_tokens: int = 1 << 18
                          ):
        """Stream (centers, contexts, words_seen) chunks: sentences are
        tokenized and buffered up to ~chunk_tokens indices, then windowed
        in one vectorized shot. A text8-scale corpus (~17M tokens, ~1e8
        pairs at window 5) never materializes more than one chunk of pairs
        (~2.6M) in RAM. Overridable (ParagraphVectors appends label pairs).
        """
        keep = self._keep_probs() if self.sample > 0 else None
        buf_idx: List[np.ndarray] = []
        buf_sid: List[np.ndarray] = []
        count = 0
        sid = 0

        words_in_buf = 0  # in-vocab tokens BEFORE subsampling: the alpha
        # decay numerator must count the same mass as its denominator
        # (sum of kept-vocab counts), which subsampling doesn't reduce

        def flush():
            idx = np.concatenate(buf_idx)
            s = np.concatenate(buf_sid)
            c, x = self._window_pairs(idx, s, self.window, rng)
            return c, x, words_in_buf

        for sentence in self.sentence_iter:
            arr = self._tokens_to_indices(sentence)
            words_in_buf += arr.size
            if keep is not None and arr.size:
                arr = arr[rng.rand(arr.size) < keep[arr]]
            if arr.size:
                buf_idx.append(arr)
                buf_sid.append(np.full(arr.size, sid, np.int32))
                count += arr.size
                sid += 1
            if count >= chunk_tokens:
                yield flush()
                buf_idx, buf_sid, count, words_in_buf = [], [], 0, 0
        if count:
            yield flush()

    def _step(self) -> SkipGramStep:
        if self._step_cache is None:
            self._step_cache = SkipGramStep(self)
        return self._step_cache

    def _tables(self) -> Dict[str, torch.Tensor]:
        """The device tables, uploading (as a copy) any that a
        `refresh_vectors` left on the host."""
        if self.syn0 is None:
            self.reset_weights()
        tables = {}
        for name in ("syn0", "syn1", "syn1neg"):
            t = getattr(self, name)
            if t is None:
                continue
            if not isinstance(t, torch.Tensor):
                t = torch.tensor(np.asarray(t, np.float32),
                                 device=self.device)
            elif t.device != self.device:
                t = t.to(self.device)
            setattr(self, name, t)
            tables[name] = t
        return tables

    def _indices(self, a) -> torch.Tensor:
        """Pair indices as int64 on the device: one upload for host
        arrays, one conversion for device tensors."""
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(self.device).to(torch.int64)

    def _train_chunk(self, tables, cb, xb, alpha: float,
                     negs=None) -> torch.Tensor:
        """(CB, B) pairs as CB steps, no read from the device; the loss of
        the last step (JAX's scan returns `losses[-1]`)."""
        step = self._step()
        loss = None
        for i in range(cb.shape[0]):
            ng = (step.draw(cb.shape[1], self._neg_gen) if negs is None
                  else negs[i])
            loss = step(tables, cb[i], xb[i], ng, alpha,
                        with_loss=i == cb.shape[0] - 1)
        return loss

    # ---------------------------------------------------- pre-mined pairs
    def mine_pairs(self, rng=None):
        """Mine every (center, context) skip-gram pair for ONE corpus
        pass, as two int32 arrays. Public surface over the chunk miner
        for callers that reuse pairs across repeated training (resumed
        runs, benchmarks) instead of re-mining per fit()."""
        if self.vocab.num_words() == 0:
            self.build_vocab()
        rng = rng or np.random.RandomState(self.seed + 1)
        chunks = list(self._iter_pair_chunks(rng))
        if not chunks:
            return np.empty(0, np.int32), np.empty(0, np.int32)
        centers = np.concatenate([c for c, _, _ in chunks])
        contexts = np.concatenate([x for _, x, _ in chunks])
        return centers, contexts

    def train_pairs(self, centers, contexts, alpha: float = None,
                    negatives=None) -> int:
        """Train on pre-mined pairs at a FIXED learning rate (callers own
        any decay schedule). Whole chunks (chunk_batches x batch_pairs)
        run with no read from the device; the tail trains in single
        batches, dropping only the sub-batch remainder — unless the whole
        input is smaller than one batch, which is tiled up. `centers` /
        `contexts` may be numpy or tensors already on the device (no
        second upload, one int64 conversion a call). `negatives`, if
        given, is an (n_pairs, negative) array of the negatives each pair
        draws, used in place of the device generator's draws (a tiled-up
        input tiles its negatives with its pairs). Returns the
        number of pairs trained; the last step's loss is `last_loss`."""
        tables = self._tables()
        step = self._step()
        alpha = self.alpha if alpha is None else float(alpha)
        centers = self._indices(centers)
        contexts = self._indices(contexts)
        if negatives is not None:
            negatives = self._indices(negatives).reshape(
                centers.numel(), self.negative)
        B, CB = self.batch_pairs, self.chunk_batches
        total = centers.numel()
        n = total // (B * CB) * (B * CB)
        loss = None
        for lo in range(0, n, B * CB):
            sl = slice(lo, lo + B * CB)
            loss = self._train_chunk(
                tables, centers[sl].view(CB, B), contexts[sl].view(CB, B),
                alpha, None if negatives is None
                else negatives[sl].view(CB, B, -1))
        trained = n

        def one(c, x, ng):
            return step(tables, c, x, step.draw(B, self._neg_gen)
                        if ng is None else ng, alpha, with_loss=True)

        tail = total - n
        for lo in range(n, n + tail // B * B, B):
            loss = one(centers[lo:lo + B], contexts[lo:lo + B],
                       None if negatives is None
                       else negatives[lo:lo + B])
            trained += B
        rem = tail % B
        if rem and trained == 0:
            # smaller than one batch: tile up so tiny inputs still train
            pad = torch.arange(B - rem, device=self.device) % rem
            c, x = centers[-rem:], contexts[-rem:]
            ng = None if negatives is None else negatives[-rem:]
            loss = one(torch.cat([c, c[pad]]), torch.cat([x, x[pad]]),
                       None if ng is None else torch.cat([ng, ng[pad]]))
            trained = rem
        if loss is not None:
            self.last_loss = loss
        self.pairs_trained += trained
        # NOTE: the similarity/nearest-words view is NOT refreshed here
        # (that would copy the whole table back every call — train_pairs
        # is built for tight loops); call refresh_vectors() when done.
        return trained

    def refresh_vectors(self) -> None:
        """Copy syn0 to the host and refresh the WordVectors view (after a
        train_pairs loop; fit() does this automatically)."""
        WordVectors.__init__(self, self.vocab, host_array(self.syn0))

    def fit(self) -> "Word2Vec":
        """reference fit :101: build vocab, Huffman, reset weights, train
        with lr decaying by words seen (Word2Vec.java :191-296's
        `alpha * (1 - wordsSeen/totalWords)`), streaming pair chunks so a
        text8-scale corpus trains in bounded memory. The JAX package's
        schedule: each mined chunk shuffled by `RandomState(seed)`,
        carried into whole (chunk_batches x batch_pairs) chunks, an
        iteration's tail in single batches, its last partial batch tiled
        up."""
        if self.sentence_iter is None:
            raise ValueError("Word2Vec needs sentences")
        if self.vocab.num_words() == 0:
            self.build_vocab()
        tables = self._tables()
        step = self._step()
        rng = np.random.RandomState(self.seed)
        # the miner runs in a prefetch thread concurrently with the
        # training loop's permutation draws — it needs its OWN RandomState
        # (numpy RandomState is not thread-safe)
        mine_rng = np.random.RandomState(self.seed + 1)

        # denominator = kept-vocab token mass (total_word_count still
        # includes mass truncate() dropped, which words_seen never counts —
        # using it would stall the decay well above min_alpha)
        kept_mass = sum(vw.count for vw in self.vocab.vocab_words())
        total_words = max(1.0, float(kept_mass) * self.iterations)
        words_seen = 0
        self.pairs_trained = 0
        loss = None
        B, CB = self.batch_pairs, self.chunk_batches
        carry_c = np.empty(0, np.int32)
        carry_x = np.empty(0, np.int32)

        def alpha_now() -> float:
            return max(self.min_alpha,
                       self.alpha * (1.0 - words_seen / total_words))

        def train_batch(bc, bx):
            return step(tables, self._indices(bc), self._indices(bx),
                        step.draw(B, self._neg_gen), alpha_now(),
                        with_loss=True)

        for _ in range(self.iterations):
            for centers, contexts, n_words in _prefetch(
                    self._iter_pair_chunks(mine_rng)):
                self.pairs_trained += centers.size
                perm = rng.permutation(centers.size)
                centers = np.concatenate([carry_c, centers[perm]])
                contexts = np.concatenate([carry_x, contexts[perm]])
                lo = 0
                while centers.size - lo >= CB * B:
                    # CB batches a chunk, alpha constant across it (decay
                    # advances per mined chunk, as in the JAX package)
                    cb = self._indices(centers[lo:lo + CB * B]).view(CB, B)
                    xb = self._indices(contexts[lo:lo + CB * B]).view(CB, B)
                    loss = self._train_chunk(tables, cb, xb, alpha_now())
                    lo += CB * B
                # remainder rides into the next chunk
                carry_c, carry_x = centers[lo:], contexts[lo:]
                # decay lags the chunk (the reference decays by words
                # ALREADY seen) so the first batch trains at full alpha and
                # the last iteration is not spent at min_alpha
                words_seen += n_words
            # iteration tail: full batches through the single-batch step,
            # then tile the final partial batch up to the batch shape
            n_full = carry_c.size // B * B
            for lo in range(0, n_full, B):
                loss = train_batch(carry_c[lo:lo + B], carry_x[lo:lo + B])
            carry_c, carry_x = carry_c[n_full:], carry_x[n_full:]
            if carry_c.size:
                pad = np.arange(B - carry_c.size) % carry_c.size
                loss = train_batch(np.concatenate([carry_c, carry_c[pad]]),
                                   np.concatenate([carry_x, carry_x[pad]]))
                carry_c = np.empty(0, np.int32)
                carry_x = np.empty(0, np.int32)
        if self.pairs_trained == 0:
            raise ValueError("No training pairs (vocab/corpus too small)")
        self.last_loss = loss
        syn0, final = read_back(tables["syn0"], loss)
        log.info("word2vec trained: %d pairs, final loss %.4f",
                 self.pairs_trained, final)
        # the WordVectors view (syn0 on the host, as in the JAX package;
        # a later train_pairs uploads it again)
        WordVectors.__init__(self, self.vocab, syn0)
        return self
