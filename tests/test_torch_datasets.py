"""The port's training data path against the JAX package on the CPU: the
dataset classes, the operator algebra of ``UnifiedDataset``, the ordered
prefetcher and the training logs.

Both packages read the same folders.  Images go through PIL on both sides,
so they compare bit for bit.  Videos are read through a stand-in
``imageio.get_reader`` (``train/synthetic.StandInReader``: frames saved with
``np.save`` under an ``.mp4`` name), because imageio may have no mp4
backend where the tests run; both packages import imageio inside the function that reads a
video, so the stand-in reaches their own frame loops, crops and resizes.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
from PIL import Image

from physicedit_tpu.train import dataset as JD
from physicedit_tpu.train import prefetch as JP
from physicedit_tpu.train import unified_dataset as JU
from physicedit_torch.train import dataset as TD
from physicedit_torch.train import logging_utils as TL
from physicedit_torch.train import prefetch as TP
from physicedit_torch.train import synthetic
from physicedit_torch.train import unified_dataset as TU


@pytest.fixture
def stand_in(monkeypatch):
    import imageio

    monkeypatch.setattr(imageio, "get_reader", synthetic.StandInReader)


def _same_image(a, b):
    return a.size == b.size and a.mode == b.mode and np.array_equal(np.asarray(a), np.asarray(b))


def _assert_same_item(got, want, path="item"):
    """Two dataset items: the same keys, images bit for bit, the rest equal."""
    if isinstance(want, Image.Image):
        assert isinstance(got, Image.Image) and _same_image(got, want), path
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in want:
            _assert_same_item(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_item(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want), path
    else:
        assert got == want, path


def _frame(i, size=(64, 48)):
    arr = np.zeros((size[1], size[0], 3), np.uint8)
    arr[:, :, 0] = (i * 23) % 256
    arr[4:12, 4 + i % 8:12 + i % 8, 1] = 255
    return Image.fromarray(arr)


# ---------------------------------------------------------------------------
# The helpers of train/dataset.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,target", [((96, 80), (64, 64)), ((64, 48), (32, 80)),
                                         ((300, 17), (48, 48)), ((77, 131), (40, 24))])
def test_crop_and_resize_bitwise(size, target):
    rng = np.random.default_rng(sum(size))
    img = Image.fromarray(rng.integers(0, 255, (size[1], size[0], 3), dtype=np.uint8))
    assert _same_image(TD.crop_and_resize(img, *target), JD.crop_and_resize(img, *target))


@pytest.mark.parametrize("w,h,max_pixels,factor", [(1920, 1080, 1920 * 1080, 16),
                                                   (4000, 3000, 1024 * 1024, 16),
                                                   (3000, 12, 1024 * 1024, 16),
                                                   (100, 70, 4096, 8), (15, 15, 10, 16)])
def test_fit_resolution(w, h, max_pixels, factor):
    assert TD.fit_resolution(w, h, max_pixels, factor) == JD.fit_resolution(w, h, max_pixels,
                                                                            factor)


@pytest.mark.parametrize("n,stride", [(0, 8), (2, 8), (3, 8), (17, 4), (49, 8), (50, 7)])
def test_key_frames_and_grid(n, stride):
    frames = [_frame(i) for i in range(n)]
    got, want = (TD.extract_middle_key_frames(frames, stride),
                 JD.extract_middle_key_frames(frames, stride))
    assert [frames.index(f) for f in got] == [frames.index(f) for f in want]
    tg, jg = TD.stitch_grid(got), JD.stitch_grid(want)
    assert (tg is None) == (jg is None) and (tg is None or _same_image(tg, jg))


def test_stitch_grid_resizes_odd_frames():
    frames = [_frame(i, (32, 24) if i != 3 else (40, 30)) for i in range(6)]
    assert _same_image(TD.stitch_grid(frames), JD.stitch_grid(frames))


@pytest.mark.parametrize("i", range(4))
def test_rule_parsing(i):
    meta = synthetic.metadata_record(i)
    if i == 2:      # rules without ids, a principle with no priority, no rule checks
        meta["stage_a"]["principles"] = [{"priority": "HIGH", "instruction": " x "},
                                         {"instruction": "y"}]
        meta.pop("stage_b")
    if i == 3:
        meta = {}
    high = TD._high_priority_rules(meta)
    assert high == JD._high_priority_rules(meta)
    assert TD._supported_contradicted(meta, high) == JD._supported_contradicted(meta, high)


# ---------------------------------------------------------------------------
# PhysicTranDataset
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def physictran(tmp_path_factory):
    """Two leaves: one written by train/synthetic.py (three kept videos, a
    fourth in the filter file), one with a video lacking metadata, a video
    whose stem is not a number and a file that is not a video."""
    root = tmp_path_factory.mktemp("physictran")
    synthetic.write_physictran_tree(str(root / "a"), n=3, excluded=1, frames=17, width=96,
                                    height=80, seed=1)
    leaf = root / "b" / "deep"
    leaf.mkdir(parents=True)
    for name, i in (("7.mp4", 7), ("12.MOV", 12), ("clip.mp4", 0)):
        with open(leaf / name, "wb") as f:
            np.save(f, synthetic.video_frames(i, 9, 40, 30))
    (leaf / "notes.txt").write_text("not a video")
    (leaf / TD.PhysicTranDataset.METADATA_FILE).write_text(
        json.dumps(synthetic.metadata_record(7)) + "\nnot json\n{\"no_idx\": 1}\n\n")
    return str(root)


@pytest.mark.parametrize("kw", [{}, {"require_meta": False}, {"repeat": 2},
                                {"height": 32, "width": 48, "num_frames": 9,
                                 "key_frame_stride": 3},
                                {"max_pixels": 3000}], ids=["default", "no_meta", "repeat",
                                                            "sized", "max_pixels"])
def test_physictran_matches_jax(physictran, stand_in, kw):
    """The sample list (paths, metadata fields, rules, order), the length,
    and every item through each package's _load_frames: frames, key frames
    and the stitched grid bit for bit."""
    got, want = TD.PhysicTranDataset(physictran, **kw), JD.PhysicTranDataset(physictran, **kw)
    assert got.samples == want.samples and len(got) == len(want)
    assert len(got.samples) == (5 if kw.get("require_meta") is False else 4)
    assert not any(s["path"].endswith(("3.mp4", "clip.mp4")) for s in got.samples)
    for i in range(len(want)):
        _assert_same_item(got[i], want[i], f"item {i}")


def test_physictran_missing_imageio_names_the_file(physictran, monkeypatch):
    """Without imageio a video read raises ImportError (as in JAX), naming
    the video; LoadVideo too."""
    monkeypatch.setitem(sys.modules, "imageio", None)
    ds = TD.PhysicTranDataset(physictran)
    with pytest.raises(ImportError, match=r"0\.mp4"):
        ds[0]
    with pytest.raises(ImportError):
        JD.PhysicTranDataset(physictran)[0]
    with pytest.raises(ImportError, match="x.mp4"):
        TU.LoadVideo()("x.mp4")


def test_physictran_unreadable_video_gives_none(tmp_path, stand_in):
    """A video that cannot be opened warns and gives None, as in JAX."""
    leaf = tmp_path / "v"
    leaf.mkdir()
    (leaf / "0.mp4").write_bytes(b"not frames")
    (leaf / TD.PhysicTranDataset.METADATA_FILE).write_text(
        json.dumps(synthetic.metadata_record(0)))
    with pytest.warns(UserWarning, match="cannot open video"):
        assert TD.PhysicTranDataset(str(tmp_path))[0] is None
    with pytest.warns(UserWarning, match="cannot open video"):
        assert JD.PhysicTranDataset(str(tmp_path))[0] is None


def test_physictran_empty_root_warns(tmp_path):
    with pytest.warns(UserWarning, match="no valid samples"):
        assert len(TD.PhysicTranDataset(str(tmp_path))) == 0


# ---------------------------------------------------------------------------
# ImageEditDataset, VideoDataset, Pica100kDataset, CachedPreprocessedDataset
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def media(tmp_path_factory):
    d = tmp_path_factory.mktemp("media")
    (d / "sub").mkdir()
    for i, name in enumerate(("a.png", "sub/b.jpg", "c.webp")):
        _frame(i, (70 + 9 * i, 50 + 5 * i)).save(d / name)
    (d / "a.txt").write_text("tip the cup\n")
    (d / "sub" / "b.txt").write_text("drop the ball")
    frames = [_frame(i) for i in range(12)]
    frames[0].save(d / "0001.gif", save_all=True, append_images=frames[1:], duration=100, loop=0)
    (d / "0001.txt").write_text("make the square glow")
    with open(d / "0002.mp4", "wb") as f:
        np.save(f, synthetic.video_frames(2, 14, 64, 48))
    (d / "0002.txt").write_text("tilt the frame")
    (d / "0003.mp4").write_bytes(b"no prompt: left out of the scan")
    (d / "ignored.dat").write_text("not media")
    rows = [{"image": "a.png", "edit_image": "sub/b.jpg", "prompt": "swap them"},
            {"image": "c.webp", "prompt": "only a target", "extra": "kept"}]
    (d / "meta.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows) + "\n")
    (d / "meta.json").write_text(json.dumps(rows))
    (d / "meta.csv").write_text("image,edit_image,prompt\na.png,sub/b.jpg,swap them\n"
                                "c.webp,a.png,\"with, comma\"\n")
    (d / "video_meta.csv").write_text("video,prompt\n0001.gif,glow\n0002.mp4,tilt\n"
                                      "a.png,still\nmissing.mp4,gone\n")
    return d


@pytest.mark.parametrize("meta", [None, "meta.jsonl", "meta.json", "meta.csv"])
@pytest.mark.parametrize("size", [{}, {"height": 32, "width": 40}], ids=["dynamic", "fixed"])
def test_image_edit_dataset_matches_jax(media, meta, size):
    path = None if meta is None else str(media / meta)
    got = TD.ImageEditDataset(str(media), path, max_pixels=2000, repeat=2, **size)
    want = JD.ImageEditDataset(str(media), path, max_pixels=2000, repeat=2, **size)
    assert got.records == want.records and len(got) == len(want)
    for i in range(len(want)):
        _assert_same_item(got[i], want[i], f"item {i}")


def test_image_edit_dataset_relative_base(media, monkeypatch):
    """Auto-pair mode keeps base-relative paths, so a relative base_path
    resolves once (JAX's fix of a double join)."""
    monkeypatch.chdir(media.parent)
    got, want = TD.ImageEditDataset(media.name), JD.ImageEditDataset(media.name)
    assert got.records == want.records and got.records[0]["image"] == "a.png"
    _assert_same_item(got[1], want[1])


@pytest.mark.parametrize("meta", [None, "video_meta.csv"])
@pytest.mark.parametrize("kw", [{"num_frames": 9, "height": 32, "width": 32},
                                {"num_frames": 100, "max_pixels": 1500},
                                {"num_frames": 5, "time_division_factor": 1,
                                 "time_division_remainder": 0}], ids=["fit", "short", "any"])
def test_video_dataset_matches_jax(media, stand_in, meta, kw):
    """The folder scan (media with a sibling prompt) or csv metadata, GIFs,
    stand-in mp4s, images as one-frame videos and frame-count fitting; a
    missing file gives None with a warning on both sides."""
    path = None if meta is None else str(media / meta)
    got, want = TD.VideoDataset(str(media), path, **kw), JD.VideoDataset(str(media), path, **kw)
    assert got.records == want.records and len(got) == len(want)
    for i in range(len(want)):
        if want.records[i]["video"] == "missing.mp4":
            with pytest.warns(UserWarning):
                assert got[i] is None
            with pytest.warns(UserWarning):
                assert want[i] is None
            continue
        _assert_same_item(got[i], want[i], f"item {i}")


def test_video_dataset_needs_base_path():
    with pytest.raises(ValueError, match="base_path"):
        TD.VideoDataset()


@pytest.fixture(scope="module")
def pica_folder(tmp_path_factory):
    import datasets

    rng = np.random.default_rng(3)

    def img(w, h):
        return Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))

    ds = datasets.Dataset.from_dict({
        "source_image": [img(80, 64), img(64, 96)], "target_image": [img(80, 64), img(64, 96)],
        "prompt": ["make it fall", "melt it"], "superficial_prompt": ["fall", None]})
    path = str(tmp_path_factory.mktemp("pica") / "ds")
    ds.save_to_disk(path)
    return path


@pytest.mark.parametrize("kw", [{}, {"height": 32, "width": 48},
                                {"prompt_column": "superficial_prompt", "max_pixels": 2000}])
def test_pica100k_local_matches_jax(pica_folder, kw):
    got = TD.Pica100kDataset(local_dataset_path=pica_folder, **kw)
    want = JD.Pica100kDataset(local_dataset_path=pica_folder, **kw)
    assert len(got) == len(want) == 2
    for i in range(2):
        _assert_same_item(got[i], want[i], f"item {i}")


def test_pica100k_needs_a_local_copy():
    with pytest.raises(ValueError, match="local_dataset_path"):
        TD.Pica100kDataset()


def test_cached_preprocessed_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    for i in (2, 0):
        np.savez_compressed(tmp_path / f"{i:06d}.npz", noise=rng.normal(size=(1, 4)),
                            mask=np.array([[True, False]]), idx=np.arange(3, dtype=np.int32))
    got, want = TD.CachedPreprocessedDataset(str(tmp_path), repeat=3), \
        JD.CachedPreprocessedDataset(str(tmp_path), repeat=3)
    assert len(got) == len(want) == 6
    for i in range(6):
        _assert_same_item(got[i], want[i])
    with pytest.raises(ValueError, match="no cached samples"):
        TD.CachedPreprocessedDataset(str(tmp_path / "empty"))


# ---------------------------------------------------------------------------
# The operators and UnifiedDataset
# ---------------------------------------------------------------------------

def test_operator_algebra_matches_jax():
    for U in (TU, JU):
        chain = U.ToStr() >> U.ToInt() >> U.ToFloat()
        assert isinstance(chain, U.DataProcessingPipeline) and chain("42") == 42.0
        assert (U.Raw() >> (U.ToList() >> U.SequentialProcess(U.ToStr())))(7) == ["7"]
        assert U.ToStr(none_value="-")(None) == "-" and U.ToAbsolutePath("/a")("b") == "/a/b"
        route = U.RouteByType([(int, U.ToStr()), (str, U.Raw()), (None, U.ToList())])
        assert route(3) == "3" and route("x") == "x" and route(2.5) == [2.5]
        with pytest.raises(ValueError):
            U.RouteByType([(int, U.Raw())])("x")
        with pytest.raises(ValueError):
            U.RouteByExtensionName([(("png",), U.Raw())])("f.exe")
        assert U.RouteByExtensionName([(("png",), U.ToList()), (None, U.Raw())])("f.PNG") == \
            ["f.PNG"]
        with pytest.raises(NotImplementedError):
            U.DataProcessingOperator()(1)


@pytest.mark.parametrize("size", [{}, {"height": 24, "width": 40}], ids=["dynamic", "fixed"])
def test_image_operators_match_jax(media, size):
    path = str(media / "sub" / "b.jpg")
    got = TU.UnifiedDataset.default_image_operator(str(media), max_pixels=1000, **size)
    want = JU.UnifiedDataset.default_image_operator(str(media), max_pixels=1000, **size)
    _assert_same_item(got("a.png"), want("a.png"))
    _assert_same_item(got(["a.png", "c.webp"]), want(["a.png", "c.webp"]))
    assert TU.LoadImage(convert_RGB=False)(path).mode == JU.LoadImage(False)(path).mode
    banner = Image.new("RGB", (3000, 12))
    assert TU.ImageCropAndResize(max_pixels=1024 * 1024).target_size(banner) == \
        JU.ImageCropAndResize(max_pixels=1024 * 1024).target_size(banner)


@pytest.mark.parametrize("delays,kw", [([100, 200, 100], {}), ([100] * 5, {}),
                                       ([40, 0, 120, 80, 40, 200], {}),
                                       ([50, 150, 100, 100, 300, 50, 50, 100],
                                        {"num_frames": 9, "time_division_factor": 4,
                                         "time_division_remainder": 1})])
def test_load_gif_variable_delay_matches_jax(tmp_path, delays, kw):
    """GIF frames resampled at the smallest positive delay when the delays
    differ (delays 100, 200, 100 give f0, f1, f1, f2), then fitted to the
    frame-count rule; frames bit for bit."""
    frames = [_frame(i) for i in range(len(delays))]
    p = tmp_path / "var.gif"
    frames[0].save(p, save_all=True, append_images=frames[1:], duration=delays, loop=0,
                   disposal=1)
    opts = {"num_frames": 16, "time_division_factor": 1, "time_division_remainder": 0, **kw}
    got, want = TU.LoadGIF(**opts)(str(p)), JU.LoadGIF(**opts)(str(p))
    _assert_same_item(got, want)
    if delays == [100, 200, 100]:
        assert len(got) == 4 and _same_image(got[1], got[2])


def test_load_video_fits_frame_count(tmp_path, stand_in):
    """LoadVideo through the stand-in reader: the largest count <= the
    request with n % factor == remainder; a reader that cannot count and
    runs short is cut to the rule."""
    p = tmp_path / "v.mp4"
    with open(p, "wb") as f:
        np.save(f, synthetic.video_frames(0, 14, 32, 24))
    for n in (5, 9, 20):
        _assert_same_item(TU.LoadVideo(n)(str(p)), JU.LoadVideo(n)(str(p)))
    assert len(TU.LoadVideo(20)(str(p))) == 13

    class Uncounted(synthetic.StandInReader):
        def count_frames(self):
            raise RuntimeError("cannot count")

    import imageio

    imageio.get_reader = Uncounted
    _assert_same_item(TU.LoadVideo(81)(str(p)), JU.LoadVideo(81)(str(p)))
    assert len(TU.LoadVideo(81)(str(p))) == 13


@pytest.mark.parametrize("meta", ["meta.jsonl", "meta.json", "meta.csv"])
def test_unified_dataset_metadata_matches_jax(media, meta):
    """Metadata rows with a default operator for the file keys and a special
    one for one key."""
    kw = dict(base_path=str(media), metadata_path=str(media / meta), repeat=2,
              data_file_keys=("image", "edit_image"))
    got = TU.UnifiedDataset(**kw, main_data_operator=TU.UnifiedDataset.default_image_operator(
        str(media), height=32, width=32), special_operator_map={
        "edit_image": TU.ToAbsolutePath(str(media)) >> TU.LoadImage()})
    want = JU.UnifiedDataset(**kw, main_data_operator=JU.UnifiedDataset.default_image_operator(
        str(media), height=32, width=32), special_operator_map={
        "edit_image": JU.ToAbsolutePath(str(media)) >> JU.LoadImage()})
    assert len(got) == len(want) == 4
    for i in range(4):
        _assert_same_item(got[i], want[i], f"item {i}")


def test_unified_dataset_video_operator_matches_jax(media, stand_in, tmp_path):
    meta = tmp_path / "m.jsonl"
    meta.write_text("".join(json.dumps({"video": v, "prompt": "p"}) + "\n"
                            for v in ("0001.gif", "0002.mp4", "a.png")))
    ops = [U.UnifiedDataset.default_video_operator(str(media), num_frames=5, height=32,
                                                   width=32) for U in (TU, JU)]
    got = TU.UnifiedDataset(str(media), str(meta), data_file_keys=("video",),
                            main_data_operator=ops[0])
    want = JU.UnifiedDataset(str(media), str(meta), data_file_keys=("video",),
                             main_data_operator=ops[1])
    for i in range(3):
        _assert_same_item(got[i], want[i], f"item {i}")
    assert [len(got[i]["video"]) for i in range(3)] == [5, 5, 1]
    with pytest.raises(ValueError, match="Unsupported file"):
        ops[0]("x.txt")


def test_unified_dataset_cache_mode_matches_jax(tmp_path):
    """Without metadata: every .npz / .pth under the base, recursively, in
    name order."""
    import torch

    (tmp_path / "z").mkdir()
    np.savez(tmp_path / "b.npz", latents=np.ones((2, 3), np.float32))
    np.savez(tmp_path / "z" / "a.npz", latents=np.zeros((2, 3), np.float32))
    torch.save({"latents": torch.full((2,), 2.0)}, tmp_path / "c.pth")
    got, want = TU.UnifiedDataset(base_path=str(tmp_path)), JU.UnifiedDataset(
        base_path=str(tmp_path))
    assert got.cached_data == want.cached_data and len(got) == len(want) == 3
    for i in range(3):
        g, w = got[i], want[i]
        assert sorted(g) == sorted(w)
        for k in w:
            assert np.array_equal(np.asarray(g[k]), np.asarray(w[k]))


def test_load_metadata_records_matches_jax(media, tmp_path):
    for name in ("meta.jsonl", "meta.json", "meta.csv", "video_meta.csv"):
        assert TU.load_metadata_records(media / name) == JU.load_metadata_records(media / name)
    with pytest.raises(ValueError, match="unsupported metadata"):
        TU.load_metadata_records(tmp_path / "x.yaml")


# ---------------------------------------------------------------------------
# The prefetcher (tests/test_prefetch.py's cases, on both packages)
# ---------------------------------------------------------------------------

class SlowDataset:
    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at
        self.in_flight = self.max_in_flight = 0
        self.lock = threading.Lock()

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        with self.lock:
            self.in_flight += 1
            self.max_in_flight = max(self.max_in_flight, self.in_flight)
        time.sleep(0.01)
        with self.lock:
            self.in_flight -= 1
        if self.fail_at is not None and i == self.fail_at:
            raise ValueError(f"decode failed at {i}")
        return None if i % 3 == 2 else {"idx": i}


@pytest.mark.parametrize("workers", [0, 1, 3])
def test_prefetch_order_matches_jax(workers):
    """Order and values (None passed through) equal the synchronous loop's
    and JAX's."""
    ds = SlowDataset(17)
    got = list(TP.prefetch_samples(ds, range(4, 17), num_workers=workers))
    assert [i for i, _ in got] == list(range(4, 17))
    assert got == list(JP.prefetch_samples(ds, range(4, 17), num_workers=workers))


@pytest.mark.parametrize("depth", [1, 4])
def test_prefetch_depth_bounds_in_flight(depth):
    ds = SlowDataset(40)
    list(TP.prefetch_samples(ds, range(40), num_workers=2, depth=depth))
    assert ds.max_in_flight <= depth
    assert ds.max_in_flight >= min(depth, 2)


def test_prefetch_decode_error_surfaces_in_order():
    ds = SlowDataset(10, fail_at=5)
    seen = []
    with pytest.raises(ValueError, match="decode failed at 5"):
        for i, _ in TP.prefetch_samples(ds, range(10), num_workers=2):
            seen.append(i)
    assert seen == [0, 1, 2, 3, 4]


def test_prefetch_stress_many_workers_keeps_order():
    """More decode threads than cores, a short switch interval: every item
    arrives once, in order, and the in-flight bound holds (bounded in time)."""
    ds = SlowDataset(120)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.perf_counter()
        got = list(TP.prefetch_samples(ds, range(120), num_workers=4 * (os.cpu_count() or 2),
                                       depth=24))
        assert time.perf_counter() - t0 < 60
    finally:
        sys.setswitchinterval(old)
    assert [i for i, _ in got] == list(range(120))
    assert got == [(i, ds[i]) for i in range(120)]
    assert ds.max_in_flight <= 24 and ds.in_flight == 0


def test_prefetch_abandoned_consumer_stops_the_pool():
    """A consumer that stops early leaves no decode running past the ones
    in flight."""
    ds = SlowDataset(100)
    gen = TP.prefetch_samples(ds, range(100), num_workers=2, depth=4)
    next(gen), next(gen)
    gen.close()
    assert ds.in_flight == 0 and ds.max_in_flight <= 4


# ---------------------------------------------------------------------------
# Logs and timings
# ---------------------------------------------------------------------------

def test_train_logger_prints_window_means(capsys):
    log = TL.TrainLogger(use_wandb=True, log_every=2)     # no wandb here: stdout
    assert log.wandb is None
    log.log_step(1, 0, {"loss": 1.0}, 0.5)
    log.log_step(2, 0, {"loss": 3.0}, 1.5)
    log.log_eval_image(2, Image.new("RGB", (4, 4)))
    log.finish()
    out = capsys.readouterr().out
    assert "wandb not installed" in out
    assert "[TRAIN] step=2 epoch=0 loss=2.0000 step_time_s=1.0000" in out
