"""paddle.text parity: Viterbi decoding + NLP datasets (the port of
``paddle_tpu/text/__init__.py``).

Reference: python/paddle/text/viterbi_decode.py (:24 viterbi_decode,
:91 ViterbiDecoder over the viterbi_decode op) and text/datasets/
(Imdb, Imikolov, UCIHousing, Conll05, Movielens, WMT14/16 — downloaders
+ parsers).

The Viterbi forward pass is one [B, N, N] max-reduction a time step on
the device of the potentials, and the backtrack walks the argmax trail
in reverse; the JAX package runs both as ``lax.scan``.  The datasets
parse LOCAL files only — there is no download: a missing file raises
with instructions instead of fetching.
"""
from __future__ import annotations

import gzip
import os
import tarfile

import numpy as np
import torch

from ..io.dataset import Dataset
from ..nn.layer.layers import Layer

__all__ = ["viterbi_decode", "ViterbiDecoder",
           "Imdb", "Imikolov", "UCIHousing", "Conll05", "Movielens",
           "WMT14", "WMT16"]


# ----------------------------------------------------------------- viterbi


def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def viterbi_decode(potentials, transition_params, lengths=None,
                   include_bos_eos_tag=True, name=None):
    """CRF Viterbi decode (reference viterbi_decode.py:24).

    potentials: [B, T, N] unary emission scores; transition_params:
    [N, N] (with BOS=N-2/EOS=N-1 rows when include_bos_eos_tag);
    lengths: [B] int actual lengths.  Returns (scores [B], paths [B, T]
    int64), on the potentials' device."""
    emis = _t(potentials)
    dev = emis.device
    trans = _t(transition_params).to(dev)
    B, T, N = emis.shape
    if lengths is None:
        lens = torch.full((B,), T, dtype=torch.int64, device=dev)
    else:
        lens = _t(lengths).to(device=dev, dtype=torch.int64)
    if include_bos_eos_tag:
        # row N-2 = BOS->tag, col N-1 = tag->EOS (reference convention)
        start = trans[N - 2]
        stop = trans[:, N - 1]
    else:
        start = torch.zeros((N,), dtype=emis.dtype, device=dev)
        stop = torch.zeros((N,), dtype=emis.dtype, device=dev)

    alpha = emis[:, 0] + start                       # [B, N]
    ident = torch.arange(N, device=dev)[None, :]
    backptrs = []
    for t in range(1, T):
        # scores[b, i, j] = alpha[b, i] + trans[i, j]
        scores = alpha[:, :, None] + trans[None]
        best_prev = torch.argmax(scores, dim=1)     # first max, as jnp
        best_score = torch.amax(scores, dim=1) + emis[:, t]
        live = (t < lens)[:, None]
        alpha = torch.where(live, best_score, alpha)
        # padded steps get IDENTITY backpointers: backtracking through
        # them carries the final tag unchanged to position len-1
        backptrs.append(torch.where(live, best_prev, ident))

    final = alpha + stop[None]
    scores = torch.amax(final, dim=-1)
    tag = torch.argmax(final, dim=-1)                # [B]
    rows = torch.arange(B, device=dev)
    path = [tag]
    for bp in reversed(backptrs):
        tag = bp[rows, tag]
        path.append(tag)
    paths = torch.stack(path[::-1], dim=1)           # [B, T]
    return scores, paths


class ViterbiDecoder(Layer):
    """Layer form (viterbi_decode.py:91): holds the transition matrix."""

    def __init__(self, transitions, include_bos_eos_tag=True, name=None):
        super().__init__()
        self.transitions = _t(transitions)
        self.include_bos_eos_tag = include_bos_eos_tag

    def forward(self, potentials, lengths=None):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self.include_bos_eos_tag)


# ----------------------------------------------------------------- datasets


def _need_file(path, what, url_hint):
    if path is None or not os.path.exists(path):
        raise FileNotFoundError(
            f"{what}: no local data file at {path!r}. This environment "
            f"has no network egress — download {url_hint} on a connected "
            f"machine and pass data_file=<local path>.")
    return path


class UCIHousing(Dataset):
    """Boston-housing regression (reference uci_housing.py): whitespace
    table of 13 features + 1 target, normalized per feature."""

    N_FEATURES = 13

    def __init__(self, data_file=None, mode="train"):
        path = _need_file(data_file, "UCIHousing", "the UCI housing.data")
        raw = np.loadtxt(path, dtype=np.float32)
        raw = raw.reshape(-1, self.N_FEATURES + 1)
        feats = raw[:, :-1]
        mn, mx = feats.min(0), feats.max(0)
        feats = (feats - mn) / np.maximum(mx - mn, 1e-8)
        n_train = int(len(raw) * 0.8)
        if mode == "train":
            self.x, self.y = feats[:n_train], raw[:n_train, -1:]
        else:
            self.x, self.y = feats[n_train:], raw[n_train:, -1:]

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


class Imikolov(Dataset):
    """PTB n-gram dataset (reference imikolov.py): builds a vocab from a
    local PTB-format text file and yields n-grams."""

    def __init__(self, data_file=None, data_type="NGRAM", window_size=5,
                 mode="train", min_word_freq=1):
        path = _need_file(data_file, "Imikolov", "PTB simple-examples")
        with open(path) as f:
            lines = [l.strip().split() for l in f if l.strip()]
        freq = {}
        for words in lines:
            for w in words:
                freq[w] = freq.get(w, 0) + 1
        vocab = sorted(w for w, c in freq.items() if c >= min_word_freq)
        self.word_idx = {w: i for i, w in enumerate(vocab)}
        self.word_idx["<unk>"] = len(self.word_idx)
        unk = self.word_idx["<unk>"]
        self.data = []
        for words in lines:
            ids = [self.word_idx.get(w, unk) for w in words]
            if data_type.upper() == "NGRAM":
                for j in range(len(ids) - window_size + 1):
                    self.data.append(
                        np.asarray(ids[j:j + window_size], np.int64))
            else:                                # SEQ
                self.data.append(np.asarray(ids, np.int64))

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return self.data[i]


class Imdb(Dataset):
    """IMDB sentiment (reference imdb.py): parses the aclImdb tar from a
    local path; yields (token-id array, 0/1 label)."""

    def __init__(self, data_file=None, mode="train", cutoff=150):
        path = _need_file(data_file, "Imdb", "aclImdb_v1.tar.gz")
        pat = f"aclImdb/{mode}"
        texts, labels = [], []
        opener = tarfile.open
        with opener(path) as tf:
            for m in tf.getmembers():
                if not m.isfile() or not m.name.startswith(pat):
                    continue
                if "/pos/" in m.name:
                    lab = 0
                elif "/neg/" in m.name:
                    lab = 1
                else:
                    continue
                body = tf.extractfile(m).read().decode("utf-8", "ignore")
                texts.append(body.lower().split())
                labels.append(lab)
        freq = {}
        for t in texts:
            for w in t:
                freq[w] = freq.get(w, 0) + 1
        # reference imdb.py build_dict: cutoff is a MINIMUM frequency —
        # keep every word appearing more than cutoff times
        vocab = [w for w, c in sorted(freq.items(),
                                      key=lambda kv: (-kv[1], kv[0]))
                 if c > cutoff]
        self.word_idx = {w: i for i, w in enumerate(vocab)}
        self.word_idx["<unk>"] = len(self.word_idx)
        unk = self.word_idx["<unk>"]
        self.docs = [np.asarray([self.word_idx.get(w, unk) for w in t],
                                np.int64) for t in texts]
        self.labels = np.asarray(labels, np.int64)

    def __len__(self):
        return len(self.docs)

    def __getitem__(self, i):
        return self.docs[i], self.labels[i]


class Conll05(Dataset):
    """CoNLL-2005 SRL test set (reference text/datasets/conll05.py:43):
    parses ``conll05st-tests.tar.gz`` (words + props column files, one
    predicate frame per props column) into per-frame samples.

    Each item: ``(words, predicate, bio_labels)`` — the sentence tokens,
    the frame's predicate word, and per-token B-/I-/O tags decoded from
    the CoNLL bracket spans.  Pass ``word_dict``/``label_dict`` to get
    int32 id arrays instead of strings."""

    WORDS_MEMBER = "conll05st-release/test.wsj/words/test.wsj.words.gz"
    PROPS_MEMBER = "conll05st-release/test.wsj/props/test.wsj.props.gz"

    def __init__(self, data_file=None, mode="test", word_dict=None,
                 label_dict=None):
        path = _need_file(data_file, "Conll05", "conll05st-tests.tar.gz")
        self.word_dict, self.label_dict = word_dict, label_dict
        self.samples = []
        with tarfile.open(path) as tf:
            words_gz = tf.extractfile(self.WORDS_MEMBER)
            props_gz = tf.extractfile(self.PROPS_MEMBER)
            with gzip.GzipFile(fileobj=words_gz) as wf, \
                    gzip.GzipFile(fileobj=props_gz) as pf:
                self._parse(wf, pf)

    def _parse(self, words_file, props_file):
        sent, cols = [], []
        for wline, pline in zip(words_file, props_file):
            word = wline.decode("utf-8").strip()
            props = pline.decode("utf-8").split()
            if not props:                        # blank line = sentence end
                self._emit(sent, cols)
                sent, cols = [], []
                continue
            sent.append(word)
            cols.append(props)
        if sent:
            self._emit(sent, cols)

    def _emit(self, sent, cols):
        if not cols:
            return
        n_frames = len(cols[0]) - 1              # col 0 = target verbs
        for i, row in enumerate(cols):
            if len(row) != len(cols[0]):
                raise ValueError(
                    f"Conll05: malformed props row for token {i} "
                    f"({sent[i]!r}) in sentence starting {sent[0]!r}: "
                    f"expected {len(cols[0])} columns (from the first "
                    f"row), got {len(row)}")
        verbs = [row[0] for row in cols if row[0] != "-"]
        for f in range(n_frames):
            spans = [row[1 + f] for row in cols]
            self.samples.append((list(sent), verbs[f] if f < len(verbs)
                                 else "-", self._bio(spans)))

    @staticmethod
    def _bio(spans):
        """CoNLL bracket spans -> BIO tags: '(TAG*' opens, '*)' closes,
        bare '*' continues the open span (or O outside one)."""
        out, tag = [], None
        for s in spans:
            opens = s.startswith("(")
            closes = s.endswith(")")
            if opens:
                tag = s[1:s.index("*")]
                out.append("B-" + tag)
            elif tag is not None:
                out.append("I-" + tag)
            else:
                out.append("O")
            if closes:
                tag = None
        return out

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        words, pred, labels = self.samples[i]
        if self.word_dict is not None:
            unk = self.word_dict.get("<unk>", 0)
            words = np.asarray([self.word_dict.get(w, unk) for w in words],
                               np.int32)
            pred = np.asarray([self.word_dict.get(pred, unk)], np.int32)
        if self.label_dict is not None:
            labels = np.asarray([self.label_dict[l] for l in labels],
                                np.int32)
        return words, pred, labels


class Movielens(Dataset):
    """MovieLens ml-1m ratings (reference text/datasets/movielens.py):
    parses ``ml-1m.zip`` (movies/users/ratings ``::``-separated, latin-1)
    into per-rating samples.

    Each item: (user_id, gender01, age_bucket, job_id, movie_id,
    category_ids, title_word_ids, rating) as int/float arrays — the
    reference's UserInfo.value() + MovieInfo.value() + [rating] feature
    tuple.  The train/test split hashes the rating line (deterministic;
    the reference consumes global numpy RNG per line, which is not
    reproducible across runs)."""

    AGE_TABLE = [1, 18, 25, 35, 45, 50, 56]

    def __init__(self, data_file=None, mode="train", test_ratio=0.1):
        import re
        import zipfile
        import zlib

        path = _need_file(data_file, "Movielens", "ml-1m.zip")
        self.mode = mode
        pat = re.compile(r"^(.*)\((\d+)\)\s*$")
        movies, users = {}, {}
        title_words, categories = set(), set()
        with zipfile.ZipFile(path) as z:
            with z.open("ml-1m/movies.dat") as f:
                for line in f:
                    mid, title, cats = \
                        line.decode("latin-1").strip().split("::")
                    cats = cats.split("|")
                    m = pat.match(title)
                    title = m.group(1).strip() if m else title
                    movies[int(mid)] = (title, cats)
                    title_words.update(w.lower() for w in title.split())
                    categories.update(cats)
            self.title_dict = {w: i for i, w in
                               enumerate(sorted(title_words))}
            self.cat_dict = {c: i for i, c in enumerate(sorted(categories))}
            with z.open("ml-1m/users.dat") as f:
                for line in f:
                    uid, gender, age, job, _zip = \
                        line.decode("latin-1").strip().split("::")
                    users[int(uid)] = (0 if gender == "M" else 1,
                                       self.AGE_TABLE.index(int(age))
                                       if int(age) in self.AGE_TABLE else 0,
                                       int(job))
            self.data = []
            with z.open("ml-1m/ratings.dat") as f:
                for line in f:
                    text = line.decode("latin-1").strip()
                    uid, mid, rating, _ts = text.split("::")
                    # crc32, not hash(): str hashing is salted per process
                    h = zlib.crc32(text.encode("latin-1")) % 1000
                    is_test = h < int(test_ratio * 1000)
                    if is_test != (mode == "test"):
                        continue
                    uid, mid = int(uid), int(mid)
                    title, cats = movies[mid]
                    g, a, j = users[uid]
                    self.data.append((
                        np.asarray([uid], np.int64),
                        np.asarray([g], np.int64),
                        np.asarray([a], np.int64),
                        np.asarray([j], np.int64),
                        np.asarray([mid], np.int64),
                        np.asarray([self.cat_dict[c] for c in cats],
                                   np.int64),
                        np.asarray([self.title_dict[w.lower()]
                                    for w in title.split()], np.int64),
                        np.asarray([float(rating) * 2 - 5.0], np.float32),
                    ))

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return self.data[i]


class WMT14(Dataset):
    """WMT'14 EN-FR preprocessed archive (reference
    text/datasets/wmt14.py): a tar with ``src.dict``/``trg.dict`` and
    ``{mode}/{mode}`` files of tab-separated parallel sentences.

    Each item: (src_ids, trg_ids, trg_ids_next) with <s>/<e> wrapping on
    the source and <s>-prefixed / <e>-suffixed target pair, UNK id 2,
    sequences longer than 80 tokens dropped in train mode."""

    START, END, UNK_IDX = "<s>", "<e>", 2
    MAX_LEN = 80

    def __init__(self, data_file=None, mode="train", dict_size=30000):
        path = _need_file(data_file, type(self).__name__,
                          "wmt14.tgz (preprocessed)")
        assert dict_size > 0
        self.mode = mode
        self.src_ids, self.trg_ids, self.trg_ids_next = [], [], []
        with tarfile.open(path) as tf:
            self.src_dict = self._dict(tf, "src.dict", dict_size)
            self.trg_dict = self._dict(tf, "trg.dict", dict_size)
            member = f"{mode}/{mode}"
            names = [m.name for m in tf if m.name.endswith(member)]
            for name in names:
                for raw in tf.extractfile(name):
                    parts = raw.decode("utf-8").strip().split("\t")
                    if len(parts) != 2:
                        continue
                    src = [self.src_dict.get(w, self.UNK_IDX)
                           for w in ([self.START] + parts[0].split()
                                     + [self.END])]
                    trg = parts[1].split()
                    # NOTE the asymmetric cap is reference-faithful:
                    # wmt14.py:149-160 measures the WRAPPED source
                    # ([<s>] + words + [<e>]) but the raw target
                    if mode == "train" and (len(src) > self.MAX_LEN or
                                            len(trg) > self.MAX_LEN):
                        continue
                    t = [self.trg_dict.get(w, self.UNK_IDX) for w in trg]
                    self.src_ids.append(src)
                    self.trg_ids.append([self.trg_dict[self.START]] + t)
                    self.trg_ids_next.append(t + [self.trg_dict[self.END]])

    @staticmethod
    def _dict(tf, suffix, size):
        names = [m.name for m in tf if m.name.endswith(suffix)]
        assert len(names) == 1, f"expected one *{suffix} in the archive"
        out = {}
        for i, line in enumerate(tf.extractfile(names[0])):
            if i >= size:
                break
            out[line.decode("utf-8").strip()] = i
        return out

    def __len__(self):
        return len(self.src_ids)

    def __getitem__(self, i):
        return (np.asarray(self.src_ids[i], np.int64),
                np.asarray(self.trg_ids[i], np.int64),
                np.asarray(self.trg_ids_next[i], np.int64))


class WMT16(WMT14):
    """WMT'16 EN-DE (reference text/datasets/wmt16.py): same archive
    protocol as WMT14 (src/trg dicts + {mode}/{mode} parallel files);
    the reference additionally rebuilds dicts from the corpus when
    missing — here the archive's dicts are required."""

