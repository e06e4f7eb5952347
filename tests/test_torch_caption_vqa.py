"""Caption and VQA data, tasks and the Generator's single-request API of
neko_tpu_torch against neko_tpu's on the CPU, at converted weights (32d, 1
layer, 2 heads, k = 64, fp32, 32x32 images: 4 patches; byte tokenizer):

* `TarShardCaptionSource`'s index and decoded samples (JPEG shards made
  with Pillow) equal neko_tpu's; a corrupt image decodes to zeros in both;
  without Pillow the port raises an ImportError naming it, where neko_tpu
  trains on zero images;
* `CaptionTask` (persisted split and explicit train / test dirs) and
  `VqaTask` (COCO-style json): splits, `sample_batch` arrays and the host
  state after them equal neko_tpu's bit for bit; `evaluate` within 1e-4
  relative; a VQA item carrying its image as an array evaluates as the file;
* `generate` (one prompt, the exact sliding window, a precomputed prompt
  embedding, per-step limits), `predict_text`, `predict_caption` and
  `predict_answer`: tokens equal, window logits within 1e-5, also with
  `num_beams > 1` (beam search).
"""

import io
import json
import os
import pickle
import shutil
import sys
import tarfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from neko_tpu.config import ModelConfig as JaxConfig  # noqa: E402
from neko_tpu.data import caption_data as jax_caption_data  # noqa: E402
from neko_tpu.data.batch import to_device_batch as jax_batch  # noqa: E402
from neko_tpu.data.packing import SequencePacker as JaxPacker  # noqa: E402
from neko_tpu.inference.generator import Generator as JaxGenerator  # noqa: E402
from neko_tpu.models.policy import NekoModel as JaxModel  # noqa: E402
from neko_tpu.tasks.caption import CaptionTask as JaxCaptionTask  # noqa: E402
from neko_tpu.tasks.vqa import VqaTask as JaxVqaTask  # noqa: E402

from neko_tpu_torch import convert  # noqa: E402
from neko_tpu_torch.config import ModelConfig  # noqa: E402
from neko_tpu_torch.data import caption_data  # noqa: E402
from neko_tpu_torch.data.batch import to_device_batch  # noqa: E402
from neko_tpu_torch.inference.generator import Generator  # noqa: E402
from neko_tpu_torch.tasks.caption import CaptionTask  # noqa: E402
from neko_tpu_torch.tasks.vqa import VqaTask  # noqa: E402

IMG = 32  # 2 x 2 patches of 16
TINY = dict(embed_dim=32, layers=1, heads=2, context_len=64, max_patches=16,
            dtype="float32", text_tokens=50257, continuous_tokens=64,
            discrete_tokens=64, dropout=0.0)
LOGIT_ATOL = 1e-5
LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module: its tensors are tiny, and in a
    parallel test run the thread pools of the workers contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ data
def jpeg_bytes(rgb: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rgb.astype(np.uint8)).save(buf, format="JPEG")
    return buf.getvalue()


def _add(tf, name, data: bytes):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def make_caption_shard(path, n=6, seed=0, corrupt=()):
    """A webdataset tar: <key>.jpg + <key>.txt (every third a .json caption);
    the samples in `corrupt` carry bytes that are no image."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.dirname(str(path)), exist_ok=True)
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            img = jpeg_bytes(rng.randint(0, 256, (IMG, IMG, 3)))
            _add(tf, f"{i:05d}.jpg", b"not a jpeg" if i in corrupt else img)
            if i % 3 == 2:
                _add(tf, f"{i:05d}.json", json.dumps({"caption": f"a json caption {i}"}).encode())
            else:
                _add(tf, f"{i:05d}.txt", f"caption number {i} of the set".encode())


def make_vqa_dir(base, sub, n=5, seed=0):
    """COCO-style questions.json + annotations.json and img<id>.jpg files
    (9-character names); question n-1 has no image file."""
    d = os.path.join(str(base), sub)
    os.makedirs(d)
    rng = np.random.RandomState(seed)
    questions, annotations = [], []
    for i in range(n):
        if i < n - 1:
            with open(os.path.join(d, f"img{str(i).zfill(6)}.jpg"), "wb") as fh:
                fh.write(jpeg_bytes(rng.randint(0, 256, (IMG, IMG, 3))))
        questions.append({"question_id": i, "image_id": i, "question": f"what is {i}?"})
        answers = [] if i == 1 else [{"answer": f"thing {i}"}, {"answer": f"item {i}"}]
        annotations.append({"question_id": i, "answers": answers})
    with open(os.path.join(d, "questions.json"), "w") as fh:
        json.dump({"questions": questions}, fh)
    with open(os.path.join(d, "annotations.json"), "w") as fh:
        json.dump({"annotations": annotations}, fh)


def vqa_kwargs(base):
    return dict(train_data=["train0"], test_data=["test0"], train_img_name_prefix=["img"],
                train_img_file_name_len=[9], test_img_name_prefix=["img"],
                test_img_file_name_len=[9])


def make_datasets(base):
    """<base>/caption (one pool of 10 samples, one corrupt) and <base>/vqa
    (train0 / test0)."""
    pytest.importorskip("PIL")
    make_caption_shard(os.path.join(str(base), "caption", "shard0.tar"), n=10, corrupt=(4,))
    make_vqa_dir(os.path.join(str(base), "vqa"), "train0", seed=1)
    make_vqa_dir(os.path.join(str(base), "vqa"), "test0", seed=2)
    return os.path.join(str(base), "caption"), os.path.join(str(base), "vqa")


def equal_examples(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        np.testing.assert_array_equal(np.asarray(g["text"]), np.asarray(w["text"]))
        assert g["images"].dtype == w["images"].dtype
        np.testing.assert_array_equal(g["images"], w["images"])


# ----------------------------------------------------------------- sources
def test_tar_source_index_and_decode_match_jax(tmp_path):
    pytest.importorskip("PIL")
    make_caption_shard(str(tmp_path / "a" / "shard0.tar"), n=6, corrupt=(3,))
    make_caption_shard(str(tmp_path / "b" / "shard1.tar"), n=4, seed=1)
    dirs = [str(tmp_path / "a"), str(tmp_path / "b")]
    want = jax_caption_data.TarShardCaptionSource(dirs, image_size=IMG)
    got = caption_data.TarShardCaptionSource(dirs, image_size=IMG)
    assert got.index == want.index and len(got) == 10
    for i in range(len(got)):
        g, w = got.get(i), want.get(i)
        assert g["caption"] == w["caption"]
        assert g["image"].dtype == w["image"].dtype == np.float32
        np.testing.assert_array_equal(g["image"], w["image"])
    assert not got.get(3)["image"].any()  # the corrupt sample
    assert got.get(2)["caption"] == "a json caption 2"
    # another size resizes, as neko_tpu does
    small = caption_data.TarShardCaptionSource(dirs, image_size=16).get(0)["image"]
    np.testing.assert_array_equal(
        small, jax_caption_data.TarShardCaptionSource(dirs, image_size=16).get(0)["image"])


def test_decode_without_pillow_names_it(tmp_path, monkeypatch):
    """A missing Pillow is an ImportError that names it, from the decoder and
    from a shard's sample (never a zero image); the package imports without
    it."""
    pytest.importorskip("PIL")
    make_caption_shard(str(tmp_path / "shard0.tar"), n=2)
    src = caption_data.TarShardCaptionSource([str(tmp_path)], image_size=IMG)
    for name in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        caption_data.decode_image_rgb(b"\xff\xd8", IMG)
    with pytest.raises(ImportError, match="Pillow"):
        src.get(0)


# ------------------------------------------------------------------- tasks
@pytest.mark.parametrize("layout", ["persisted_split", "train_test_dirs"])
def test_caption_task_split_and_sampling_match_jax(tmp_path, layout):
    pytest.importorskip("PIL")
    roots = [tmp_path / "jax", tmp_path / "port"]
    for root in roots:
        if layout == "persisted_split":
            make_caption_shard(str(root / "shard0.tar"), n=10, corrupt=(4,))
        else:
            make_caption_shard(str(root / "tr" / "s.tar"), n=7)
            make_caption_shard(str(root / "te" / "s.tar"), n=3, seed=5)
    kw = dict(test_data_prop=0.3, seed=3, image_size=IMG, context_length=64)
    if layout == "train_test_dirs":
        kw.update(train_data=["tr"], test_data=["te"])
    jtask = JaxCaptionTask(str(roots[0]), **kw)
    task = CaptionTask(str(roots[1]), **kw)
    np.testing.assert_array_equal(task.train_indices, jtask.train_indices)
    np.testing.assert_array_equal(task.test_indices, jtask.test_indices)
    assert (task.patches_per_image, task.max_text_tokens) == (jtask.patches_per_image,
                                                              jtask.max_text_tokens)
    if layout == "persisted_split":
        assert len(task.test_indices) == 3
        with open(roots[1] / "test_data_mask.json") as fh:
            assert json.load(fh) == json.load(open(roots[0] / "test_data_mask.json"))
        again = CaptionTask(str(roots[1]), **{**kw, "seed": 99})  # the mask is reused
        np.testing.assert_array_equal(again.test_indices, task.test_indices)
    for n in (1, 4, 12):
        equal_examples(task.sample_batch(n), jtask.sample_batch(n))
    equal_examples(task.sample_batch(2, is_test=True), jtask.sample_batch(2, is_test=True))
    assert pickle.dumps(task.host_state()) == pickle.dumps(jtask.host_state())


def test_vqa_task_split_and_sampling_match_jax(tmp_path):
    _, vqa_dir = make_datasets(tmp_path)
    kw = dict(vqa_kwargs(tmp_path), seed=4, image_size=IMG, context_length=64)
    jtask, task = JaxVqaTask(vqa_dir, **kw), VqaTask(vqa_dir, **kw)
    assert task.train_items == jtask.train_items and len(task.train_items) == 4
    assert task.test_items == jtask.test_items
    for n in (1, 5):
        equal_examples(task.sample_batch(n), jtask.sample_batch(n))
    assert pickle.dumps(task.host_state()) == pickle.dumps(jtask.host_state())


def test_image_larger_than_the_context_raises():
    with pytest.raises(ValueError, match="raise -k"):
        VqaTask("", [], [], image_size=256, context_length=64, items=([], []))
    with pytest.raises(ValueError, match="multiple of"):
        CaptionTask("", image_size=40, context_length=64)


@pytest.fixture(scope="module")
def gens():
    jcfg = JaxConfig(**TINY)
    jmodel = JaxModel(jcfg)
    packer = JaxPacker(jcfg)
    arrays = packer.pack_batch([{"text": [1, 2], "images": np.zeros((1, IMG, IMG, 3))}])
    arrays.pop("lengths")
    params = jax.jit(jmodel.init)({"params": jax.random.key(8)}, jax_batch(arrays))["params"]
    cfg = ModelConfig(**TINY)
    sd = convert.jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), cfg)
    return (JaxGenerator(jmodel, params, JaxPacker(jcfg)),
            Generator(convert.build_model(cfg, sd, device="cpu")))


def test_caption_and_vqa_evaluate_match_jax(tmp_path, gens):
    jgen, gen = gens
    cap_dir, vqa_dir = make_datasets(tmp_path)
    ckw = dict(test_data_prop=0.5, seed=1, image_size=IMG, context_length=64)
    shutil.copytree(cap_dir, str(tmp_path / "caption_jax"))
    jcap = JaxCaptionTask(str(tmp_path / "caption_jax"), **ckw)
    cap = CaptionTask(cap_dir, **ckw)
    vkw = dict(vqa_kwargs(tmp_path), seed=2, image_size=IMG, context_length=64)
    jvqa, vqa = JaxVqaTask(vqa_dir, **vkw), VqaTask(vqa_dir, **vkw)
    for jtask, task, n in ((jcap, cap, 3), (jvqa, vqa, 4)):
        want = jtask.evaluate(jgen, num_examples_to_test=n)
        got = task.evaluate(gen, num_examples_to_test=n)
        assert set(got) == set(want) == {"loss", "perplexity"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)
        assert np.isfinite(got["loss"]) and got["loss"] > 0
    # the answer choices came from eval_rng: the training stream is untouched
    assert pickle.dumps(vqa.host_state()) == pickle.dumps(jvqa.host_state())
    # items whose image is an array evaluate as the files they came from
    arrays = VqaTask(vqa_dir, **{**vkw, "items": (
        vqa.train_items, [{**it, "image": vqa._image(it)} for it in vqa.test_items])})
    assert all("image" in it for it in arrays.test_items)
    got = arrays.evaluate(gen, num_examples_to_test=4)
    again = VqaTask(vqa_dir, **vkw).evaluate(gen, num_examples_to_test=4)
    assert got == again


# -------------------------------------------------------------- generation
def _image(seed):
    return np.random.RandomState(seed).randint(0, 256, (1, IMG, IMG, 3)).astype(np.float32)


@pytest.mark.parametrize("case", ["caption", "caption_past_the_context", "answer", "text",
                                  "text_past_the_context"])
def test_predict_calls_match_jax(gens, case):
    jgen, gen = gens
    name, args, n = {
        "caption": ("predict_caption", (_image(1),), 6),
        "caption_past_the_context": ("predict_caption", (_image(2),), 70),
        "answer": ("predict_answer", (_image(3), [104, 105, 33]), 5),
        "text": ("predict_text", ({"text": list(range(40, 60))},), 8),
        "text_past_the_context": ("predict_text", ({"text": list(range(40, 80))},), 40),
    }[case]
    want_logits, want_ids = getattr(jgen, name)(*args, max_length=n)
    got_logits, got_ids = getattr(gen, name)(*args, max_length=n)
    assert got_ids.dtype == np.int64 and got_ids.shape == (n,)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got_logits, want_logits, rtol=0, atol=LOGIT_ATOL)


@pytest.mark.parametrize("case", ["drop_trailing_inner_pos", "exact_window", "prompt_emb",
                                  "step_limits"])
def test_generate_matches_jax(gens, case):
    jgen, gen = gens
    ts = gen.cfg.token_space
    text = dict(start=ts.start("text"), end=ts.end("text"))
    example = {"images": _image(5), "text": [70, 71, 72]}
    if case == "drop_trailing_inner_pos":
        kw = dict(example=example, max_new_tokens=9, drop_trailing=1,
                  inner_pos_continuation=True, **text)
    elif case == "exact_window":  # 57 + 20 tokens > 64: re-prefills past the context
        kw = dict(example={"text": list(range(1, 57))}, max_new_tokens=20, exact_window=True,
                  **text)
    elif case == "step_limits":
        kw = dict(example=example, max_new_tokens=3, step_limits=[3, 1, 5],
                  start=ts.start("discrete"), end=ts.start("discrete") + 4)
    if case == "prompt_emb":
        arrays = gen.packer.pack_batch([example], pad_side="right")
        L = int(arrays.pop("lengths")[0])
        with torch.no_grad():
            emb = gen.model.embed_batch(to_device_batch(arrays, "cpu"))
        jemb = jgen._embed_batch(jgen.params, jax_batch(arrays))
        want = jgen.generate(None, prompt_emb=jemb, prompt_len=L, max_new_tokens=12,
                             inner_pos_continuation=True, **text)
        got = gen.generate(prompt_emb=emb, prompt_len=L, max_new_tokens=12,
                           inner_pos_continuation=True, **text)
    else:
        ex = kw.pop("example")
        want, got = jgen.generate(ex, **kw), gen.generate(ex, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=0, atol=LOGIT_ATOL)
    if case == "step_limits":
        assert all(t - ts.start("discrete") < lim for t, lim in zip(got[0], [3, 1, 5]))


@pytest.mark.parametrize("case", ["caption", "answer"])
def test_predict_calls_with_beams_match_jax(gens, case):
    jgen, gen = gens
    name, args = {"caption": ("predict_caption", (_image(6),)),
                  "answer": ("predict_answer", (_image(7), [104, 105, 33]))}[case]
    want_logits, want_ids = getattr(jgen, name)(*args, max_length=4, num_beams=3)
    got_logits, got_ids = getattr(gen, name)(*args, max_length=4, num_beams=3)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got_logits, np.asarray(want_logits), rtol=0, atol=LOGIT_ATOL)
