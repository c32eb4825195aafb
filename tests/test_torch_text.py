"""The port's ``text`` (``viterbi_decode``, ``ViterbiDecoder`` and the seven
local-file datasets) against the JAX package's.

Viterbi decoding is held to JAX's scores (fp32 1e-5) and paths (exact)
on seeded potentials, with and without the BOS/EOS rows and with ragged
lengths, and to an exhaustive search.  Each dataset reads a synthetic
archive built in ``tmp_path`` in its official layout (as
``tests/test_text_datasets.py`` builds them; nothing is downloaded) and
every item equals the JAX package's; the missing-file errors keep JAX's
directed messages."""
import gzip
import io
import itertools
import tarfile
import zipfile

import numpy as np
import pytest
import torch

import paddle_tpu.text as jtext

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.text as ttext

tpaddle.set_device("cpu")


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(getattr(x, "data", x))


def _same_items(t, j):
    assert len(t) == len(j)
    for i in range(len(j)):
        a, b = t[i], j[i]
        if isinstance(b, (tuple, list)):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                if isinstance(y, (str, list)) and not isinstance(y,
                                                                 np.ndarray):
                    assert x == y
                else:
                    np.testing.assert_array_equal(x, y)
                    assert np.asarray(x).dtype == np.asarray(y).dtype
        else:
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- viterbi


@pytest.mark.parametrize("bos_eos", [True, False])
@pytest.mark.parametrize("lengths", [None, [5, 3, 1, 4]])
def test_viterbi_matches_jax(bos_eos, lengths):
    rng = np.random.RandomState(0)
    B, T, N = 4, 5, 6
    emis = rng.randn(B, T, N).astype(np.float32)
    trans = rng.randn(N, N).astype(np.float32)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    js, jp = jtext.viterbi_decode(emis, trans, lens, bos_eos)
    ts, tp = ttext.viterbi_decode(torch.tensor(emis), torch.tensor(trans),
                                  None if lens is None
                                  else torch.tensor(lens), bos_eos)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5,
                               rtol=1e-5)
    assert tp.dtype == torch.int64
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_viterbi_matches_exhaustive_search():
    rng = np.random.RandomState(1)
    B, T, N = 3, 4, 4
    emis = rng.randn(B, T, N).astype(np.float32)
    trans = rng.randn(N, N).astype(np.float32)
    scores, paths = ttext.viterbi_decode(torch.tensor(emis),
                                         torch.tensor(trans))
    start, stop = trans[N - 2], trans[:, N - 1]
    for b in range(B):
        best, path = -1e30, None
        for tags in itertools.product(range(N), repeat=T):
            s = start[tags[0]] + emis[b, 0, tags[0]]
            for t in range(1, T):
                s += trans[tags[t - 1], tags[t]] + emis[b, t, tags[t]]
            s += stop[tags[-1]]
            if s > best:
                best, path = s, list(tags)
        np.testing.assert_allclose(float(scores[b]), best, rtol=1e-5)
        assert paths[b].tolist() == path


def test_viterbi_decoder_layer_matches_jax():
    rng = np.random.RandomState(2)
    emis = rng.randn(2, 6, 3).astype(np.float32)
    trans = rng.randn(3, 3).astype(np.float32)
    lens = np.array([4, 6], np.int64)
    jdec = jtext.ViterbiDecoder(trans, include_bos_eos_tag=False)
    tdec = ttext.ViterbiDecoder(torch.tensor(trans),
                                include_bos_eos_tag=False)
    import paddle_tpu as jpaddle

    js, jp = jdec(jpaddle.to_tensor(emis), jpaddle.to_tensor(lens))
    ts, tp = tdec(torch.tensor(emis), torch.tensor(lens))
    np.testing.assert_allclose(ts.numpy(), _np(js), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tp.numpy(), _np(jp))


# ------------------------------------------------------------ datasets


def _tar_add(tf, name, data: bytes):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


@pytest.fixture()
def conll_archive(tmp_path):
    words = "\n".join(["The", "cat", "sat", "", "Dogs", "bark", "loud",
                       ""]) + "\n"
    props = "\n".join(["-    (A0*    *", "-    *)      *",
                       "sat  (V*)    (A1*)", "",
                       "-     (A0*)", "bark  (V*)", "-     *", ""]) + "\n"
    path = tmp_path / "conll05st-tests.tar.gz"
    with tarfile.open(path, "w:gz") as tf:
        _tar_add(tf, jtext.Conll05.WORDS_MEMBER,
                 gzip.compress(words.encode()))
        _tar_add(tf, jtext.Conll05.PROPS_MEMBER,
                 gzip.compress(props.encode()))
    return str(path)


@pytest.mark.parametrize("dicts", [False, True])
def test_conll05_matches_jax(conll_archive, dicts):
    kw = {}
    if dicts:
        kw = dict(word_dict={"<unk>": 0, "The": 1, "cat": 2, "sat": 3},
                  label_dict={"B-A0": 0, "I-A0": 1, "B-V": 2, "O": 3,
                              "B-A1": 4})
    t = ttext.Conll05(conll_archive, **kw)
    j = jtext.Conll05(conll_archive, **kw)
    assert len(t) == 3
    _same_items(t, j)


@pytest.fixture()
def ml1m_archive(tmp_path):
    path = tmp_path / "ml-1m.zip"
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("ml-1m/movies.dat",
                   "1::Toy Story (1995)::Animation|Comedy\n"
                   "2::Heat (1995)::Action|Crime\n"
                   "3::Up::Animation\n")
        z.writestr("ml-1m/users.dat",
                   "1::M::25::12::90210\n2::F::35::7::10001\n"
                   "3::F::99::1::02139\n")
        z.writestr("ml-1m/ratings.dat", "".join(
            f"{u}::{m}::{(u * m) % 5 + 1}::97830{u}{m}\n"
            for u in (1, 2, 3) for m in (1, 2, 3)))
    return str(path)


@pytest.mark.parametrize("mode,ratio", [("train", 0.0), ("train", 0.5),
                                        ("test", 0.5)])
def test_movielens_matches_jax(ml1m_archive, mode, ratio):
    t = ttext.Movielens(ml1m_archive, mode=mode, test_ratio=ratio)
    j = jtext.Movielens(ml1m_archive, mode=mode, test_ratio=ratio)
    _same_items(t, j)
    assert t.title_dict == j.title_dict and t.cat_dict == j.cat_dict


@pytest.fixture()
def wmt_archive(tmp_path):
    path = tmp_path / "wmt14.tgz"
    with tarfile.open(path, "w:gz") as tf:
        _tar_add(tf, "wmt14/src.dict", b"<s>\n<e>\n<unk>\nhello\nworld\n")
        _tar_add(tf, "wmt14/trg.dict",
                 b"<s>\n<e>\n<unk>\nbonjour\nmonde\n")
        _tar_add(tf, "wmt14/train/train",
                 b"hello world\tbonjour monde\nhello\tbonjour\nbad line\n"
                 + ("hello " * 90).encode() + b"\tmonde\n")
        _tar_add(tf, "wmt14/test/test", b"world\tmonde\nx y\tz\n")
    return str(path)


@pytest.mark.parametrize("cls", ["WMT14", "WMT16"])
@pytest.mark.parametrize("mode,size", [("train", 100), ("test", 100),
                                       ("test", 3)])
def test_wmt_matches_jax(wmt_archive, cls, mode, size):
    t = getattr(ttext, cls)(wmt_archive, mode=mode, dict_size=size)
    j = getattr(jtext, cls)(wmt_archive, mode=mode, dict_size=size)
    _same_items(t, j)


def test_imdb_matches_jax(tmp_path):
    path = tmp_path / "aclImdb.tar.gz"
    docs = {"aclImdb/train/pos/0_9.txt": b"good good good film",
            "aclImdb/train/neg/1_2.txt": b"bad bad film night",
            "aclImdb/train/unsup/3_0.txt": b"ignored label",
            "aclImdb/test/pos/0_8.txt": b"ignored split"}
    with tarfile.open(path, "w:gz") as tf:
        for name, body in docs.items():
            _tar_add(tf, name, body)
    for cutoff in (0, 1):
        t = ttext.Imdb(str(path), mode="train", cutoff=cutoff)
        j = jtext.Imdb(str(path), mode="train", cutoff=cutoff)
        assert t.word_idx == j.word_idx
        _same_items(t, j)


@pytest.mark.parametrize("data_type,window", [("NGRAM", 3), ("SEQ", 5)])
def test_imikolov_matches_jax(tmp_path, data_type, window):
    f = tmp_path / "ptb.train.txt"
    f.write_text("the cat sat on the mat\n\nthe dog sat\na b\n")
    kw = dict(data_file=str(f), data_type=data_type, window_size=window,
              min_word_freq=2 if data_type == "SEQ" else 1)
    t, j = ttext.Imikolov(**kw), jtext.Imikolov(**kw)
    assert t.word_idx == j.word_idx
    _same_items(t, j)


def test_uci_housing_matches_jax(tmp_path):
    rows = np.random.RandomState(0).rand(20, 14).astype(np.float32)
    f = tmp_path / "housing.data"
    np.savetxt(f, rows)
    for mode in ("train", "test"):
        t = ttext.UCIHousing(data_file=str(f), mode=mode)
        j = jtext.UCIHousing(data_file=str(f), mode=mode)
        _same_items(t, j)


@pytest.mark.parametrize("cls", ["UCIHousing", "Imikolov", "Imdb",
                                 "Conll05", "Movielens", "WMT14", "WMT16"])
def test_missing_files_raise_jax_directed_message(cls):
    with pytest.raises(FileNotFoundError) as want:
        getattr(jtext, cls)(data_file="/nonexistent/file")
    with pytest.raises(FileNotFoundError) as got:
        getattr(ttext, cls)(data_file="/nonexistent/file")
    assert str(got.value) == str(want.value)
    assert "no network egress" in str(got.value)
