"""NLP stack: text pipeline, vocab, embeddings (Word2Vec/GloVe/doc2vec).

Parity: reference deeplearning4j-scaleout/deeplearning4j-nlp (SURVEY §2.6) —
sentence iterators, tokenizer factories, VocabCache, Huffman coding,
Word2Vec (skip-gram with hierarchical softmax + negative sampling), GloVe,
ParagraphVectors, bag-of-words/TF-IDF vectorizers, word-vector serializer.
The port's counterpart of the JAX package's `nlp/`, with the same names.

Design: the reference's per-pair hogwild axpy hot loop
(InMemoryLookupTable.iterateSample :188) becomes BATCHED device training —
pairs are mined on the host (the JAX package's numpy code, so the pairs
are identical), shipped as index tensors, and one step a batch runs on
the device: gathers, a batched dot, and the gradients summed into the
tables by `index_add_`. The trainers take `device=` (None = the card,
raising without one).

The constituency trees (`Tree`, `binarize`, `parse_tree`, `nlp/tree.py`)
and the RNTN over them (`nlp/rntn.py`: a level schedule on the device,
one batched step a tree level), with the sentiment lexicon
(`nlp/sentiment.py`) and the HMM POS tagger (`nlp/pos.py`), complete the
JAX package's `nlp/`.
"""

from deeplearning4j_tpu_torch.nlp.tokenization import (  # noqa: F401
    DefaultTokenizer,
    DefaultTokenizerFactory,
    NGramTokenizerFactory,
    WhitespaceTokenizer,
    WhitespaceTokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.sentence_iterator import (  # noqa: F401
    CollectionSentenceIterator,
    FileSentenceIterator,
    LabelAwareSentenceIterator,
    LineSentenceIterator,
)
from deeplearning4j_tpu_torch.nlp.documents import (  # noqa: F401
    DocumentIterator,
    FileDocumentIterator,
    InvertedIndex,
    LabelAwareDocumentIterator,
)
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabWord  # noqa: F401
from deeplearning4j_tpu_torch.nlp.huffman import build_huffman  # noqa: F401
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec  # noqa: F401
from deeplearning4j_tpu_torch.nlp.word2vec_iterator import (  # noqa: F401
    Word2VecDataFetcher,
    Word2VecDataSetIterator,
    viterbi_smooth,
)
from deeplearning4j_tpu_torch.nlp.glove import CoOccurrences, Glove  # noqa: F401
from deeplearning4j_tpu_torch.nlp.paragraph_vectors import (  # noqa: F401
    ParagraphVectors,
)
from deeplearning4j_tpu_torch.nlp.serializer import (  # noqa: F401
    load_word_vectors,
    save_word_vectors,
)
from deeplearning4j_tpu_torch.nlp.vectorizers import (  # noqa: F401
    BagOfWordsVectorizer,
    TfidfVectorizer,
)
from deeplearning4j_tpu_torch.nlp.tree import (  # noqa: F401
    Tree,
    binarize,
    parse_tree,
)
from deeplearning4j_tpu_torch.nlp.rntn import RNTN  # noqa: F401
