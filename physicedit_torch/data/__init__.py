"""Host-side media IO (the reference's public ``diffsynth.data`` surface;
``physicedit_tpu/data``)."""

from physicedit_torch.data.video import (
    LowMemoryImageFolder,
    LowMemoryVideo,
    VideoData,
    crop_and_resize,
    merge_video_audio,
    save_frames,
    save_video,
    save_video_with_audio,
    search_for_images,
)

__all__ = [
    "LowMemoryImageFolder",
    "LowMemoryVideo",
    "VideoData",
    "crop_and_resize",
    "merge_video_audio",
    "save_frames",
    "save_video",
    "save_video_with_audio",
    "search_for_images",
]
