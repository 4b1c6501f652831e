"""Host-side tokenisation: gensim-compatible tokenizer, token dictionary,
stop-word removal.

A copy of ``fumi_tpu/data/vocab.py``, which is pure Python: the port keeps
its own because importing anything under ``fumi_tpu`` pulls in JAX.
``tests/test_torch_data.py`` holds the copy equal to the original.

It replaces the reference's gensim/nltk dependencies (ref:
fumi/dataset/data.py:433-469, fumi/models/common.py:164-196) with
self-contained equivalents (gensim/nltk corpora need network downloads):

- :func:`tokenize` matches ``gensim.utils.tokenize``'s alphabetic pattern
  (sequences of word characters not starting with a digit).
- :class:`Dictionary` is a token↔id map built over ALL folds
  (ref: data.py:461-466); ids are assigned in first-appearance order
  (documented deviation: gensim's internal id assignment order differs, but
  ids are an internal detail — embeddings are keyed by word).
- ``STOP_WORDS`` is the standard English stop-word list (equivalent to
  ``nltk.corpus.stopwords.words("english")``).
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List

# gensim PAT_ALPHABETIC: word chars, not starting with a digit
_TOKEN_PAT = re.compile(r"(((?![\d])\w)+)", re.UNICODE)

PAD_WORD = "<PAD>"

# nltk English stop words (standard public word list, 179 entries)
STOP_WORDS = frozenset("""
i me my myself we our ours ourselves you you're you've you'll you'd your
yours yourself yourselves he him his himself she she's her hers herself it
it's its itself they them their theirs themselves what which who whom this
that that'll these those am is are was were be been being have has had having
do does did doing a an the and but if or because as until while of at by for
with about against between into through during before after above below to
from up down in out on off over under again further then once here there when
where why how all any both each few more most other some such no nor not only
own same so than too very s t can will just don don't should should've now d
ll m o re ve y ain aren aren't couldn couldn't didn didn't doesn doesn't
hadn hadn't hasn hasn't haven haven't isn isn't ma mightn mightn't mustn
mustn't needn needn't shan shan't shouldn shouldn't wasn wasn't weren weren't
won won't wouldn wouldn't
""".split())


def tokenize(text: str, lowercase: bool = False) -> List[str]:
    """gensim.utils.tokenize-compatible tokenizer."""
    if lowercase:
        text = text.lower()
    return [m.group() for m in _TOKEN_PAT.finditer(text)]


def remove_stop_words(text: str) -> str:
    """Whitespace-split stop-word filter (ref: data.py:433-439 uses
    ``s.split()``, not the tokenizer)."""
    return " ".join(w for w in text.split() if w not in STOP_WORDS)


class Dictionary:
    """token2id map over an iterable of documents (token lists)."""

    def __init__(self, documents: Iterable[List[str]] = ()):
        self.token2id: Dict[str, int] = {}
        for doc in documents:
            self.add_document(doc)

    def add_document(self, tokens: List[str]) -> None:
        for t in tokens:
            if t not in self.token2id:
                self.token2id[t] = len(self.token2id)

    def __len__(self) -> int:
        return len(self.token2id)

    def __getitem__(self, token: str) -> int:
        return self.token2id[token]

    def get(self, token, default=None):
        return self.token2id.get(token, default)

    def items(self):
        return self.token2id.items()


def encode_padded(descriptions: List[str], dictionary: Dictionary,
                  lowercase: bool = True):
    """Tokenise + pad to the max length with ``<PAD>`` ids.

    Mirrors ref data.py:450-469: descriptions are lowercased, padded with
    ``<PAD>`` words to the max token length across the split, then mapped
    through token2id. Returns (tokens (C, T) int32, mask (C, T) int32).
    """
    import numpy as np

    token_lists = [tokenize(d.lower() if lowercase else d)
                   for d in descriptions]
    max_len = max((len(t) for t in token_lists), default=1)
    pad_id = dictionary[PAD_WORD]
    C = len(token_lists)
    out = np.full((C, max_len), pad_id, dtype=np.int32)
    mask = np.zeros((C, max_len), dtype=np.int32)
    for i, toks in enumerate(token_lists):
        ids = [dictionary[t] for t in toks]
        out[i, :len(ids)] = ids
        mask[i, :len(ids)] = 1
    return out, mask
