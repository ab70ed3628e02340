"""The port's video IO (``physicedit_torch/data/video.py``) against the JAX
package's (``physicedit_tpu/data/video.py``): natural order, crop geometry
bit for bit, the folder readers and writers, and a missing imageio."""

import sys

import numpy as np
import pytest
from PIL import Image

from physicedit_tpu.data import video as jv
from physicedit_torch.data import video as tv
from tests.test_data_video import _frame, _has_ffmpeg_writer, _ref_split_file_name


def _names(paths):
    return [p.rsplit("/", 1)[-1] for p in paths]


@pytest.mark.parametrize("names", [
    ["frame10.png", "frame2.png", "frame1.jpg", "frame11b2.png", "frame9b30.png"],
    ["03.png", "zz.png", "0004.png", "a1.png"],            # mixed naming schemes
    ["img_100.jpg", "img_20.jpg", "img_3.png", "img_3a.png", "IMG_1.png"],
])
def test_natural_order_matches_jax(tmp_path, names):
    for n in names:
        _frame(0, (8, 8)).save(tmp_path / n)
    (tmp_path / "notes.txt").write_text("x")
    got = _names(tv.search_for_images(str(tmp_path)))
    assert got == _names(jv.search_for_images(str(tmp_path)))
    assert "notes.txt" not in got and len(got) == len(names)
    if names[0].startswith("frame"):    # one scheme: the reference's own key
        assert got == sorted(names, key=_ref_split_file_name)


@pytest.mark.parametrize("src,dst", [
    ((120, 64), (32, 32)), ((50, 90), (32, 32)), ((64, 48), (48, 64)), ((33, 47), (16, 24)),
    ((16, 12), (64, 48)), ((20, 31), (96, 40)),       # upscaling
    ((896, 512), (832, 480)),                          # the video phase's frames
])
def test_crop_and_resize_bit_for_bit(src, dst):
    rng = np.random.default_rng(0)
    img = Image.fromarray(rng.integers(0, 255, (src[1], src[0], 3), np.uint8))
    got = np.asarray(tv.crop_and_resize(img, dst[1], dst[0]))
    assert got.shape == (dst[1], dst[0], 3)
    np.testing.assert_array_equal(got, np.asarray(jv.crop_and_resize(img, dst[1], dst[0])))


def test_video_data_and_folder_readers_match_jax(tmp_path):
    for i in range(5):
        _frame(i).save(tmp_path / f"{i}.png")
    with tv.VideoData(image_folder=str(tmp_path), height=32, width=24) as v, \
            jv.VideoData(image_folder=str(tmp_path), height=32, width=24) as w:
        assert v.data_type == "images" and len(v) == len(w) == 5
        assert v.shape() == w.shape() == (32, 24)
        for i in range(5):
            np.testing.assert_array_equal(np.asarray(v[i]), np.asarray(w[i]))
        v.set_length(3)
        assert len(v) == 3 and len(v.raw_data()) == 3
    native = tv.VideoData(image_folder=str(tmp_path))
    assert native[1].size == (64, 48) and native.shape() == (48, 64)
    native.set_length(2)
    native.save_images(str(tmp_path / "dump"))
    assert sorted(p.name for p in (tmp_path / "dump").iterdir()) == ["0.png", "1.png"]
    folder = tv.LowMemoryImageFolder(str(tmp_path), file_list=["3.png", "1.png"])
    assert len(folder) == 2
    np.testing.assert_array_equal(np.asarray(folder[0]), np.asarray(_frame(3)))
    with pytest.raises(ValueError):
        tv.VideoData()


def test_save_frames_writes_what_jax_writes(tmp_path):
    frames = [_frame(i) for i in range(3)]
    tv.save_frames(frames, str(tmp_path / "port"))
    jv.save_frames(frames, str(tmp_path / "jax"))
    for i in range(3):
        a = np.asarray(Image.open(tmp_path / "port" / f"{i}.png"))
        b = np.asarray(Image.open(tmp_path / "jax" / f"{i}.png"))
        np.testing.assert_array_equal(a, b)


def test_save_video_roundtrip(tmp_path):
    if not _has_ffmpeg_writer(tmp_path):
        pytest.skip("imageio ffmpeg plugin unavailable")
    path = tmp_path / "clip.mp4"
    tv.save_video([_frame(i) for i in range(6)], str(path), fps=8)
    with tv.VideoData(video_file=str(path), height=24, width=24) as v:
        assert v.data_type == "video" and len(v) == 6 and v[2].size == (24, 24)


def test_a_video_without_imageio_names_the_file(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "imageio", None)
    path = str(tmp_path / "clip.mp4")
    with pytest.raises(ImportError, match="clip.mp4"):
        tv.VideoData(video_file=path)
    with pytest.raises(ImportError, match="clip.mp4"):
        tv.save_video([_frame(0)], path, fps=8)
    # image folders need PIL alone
    _frame(0).save(tmp_path / "0.png")
    assert len(tv.VideoData(image_folder=str(tmp_path))) == 1


def test_merge_video_audio_missing_inputs(tmp_path):
    with pytest.raises(FileNotFoundError):
        tv.merge_video_audio(str(tmp_path / "none.mp4"), str(tmp_path / "none.wav"))
