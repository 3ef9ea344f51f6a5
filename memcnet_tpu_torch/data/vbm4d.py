"""VBM4D 8-video enhancement dataset (datasets_benchmark/VBM4D.py:40-49,
listdatasets_vbm4d.py:13-86; port of memcnet_tpu/data/vbm4d.py): per frame,
a 7-frame window centered on it (missing edge frames fall back to the center
frame), target from noise_free_imgs.  Frame names carry a 4-digit index
before the extension."""

import os

from memcnet_tpu_torch.data.middlebury import read_frame

VIDEOS = [
    "coastguard", "gbicycle", "gbus", "gflower",
    "gforeman", "gmissa", "gsalesman", "gstennis",
]


def input_dir(root, task, task_param):
    if task == "denoise":
        return os.path.join(root, f"noisy_sigma{int(task_param[0])}_imgs_3ch")
    if task == "deblock":
        return os.path.join(root, f"blocky_H264qp{int(task_param[0])}_imgs")
    raise ValueError(task)


def load_window(root, video, frame_file, task, task_param):
    base = os.path.join(input_dir(root, task, task_param), video)
    cur = int(frame_file[-8:-4])
    frames = []
    for i in range(7):
        p = os.path.join(base, frame_file[:-8] + str(cur - 3 + i).zfill(4) + frame_file[-4:])
        if not os.path.exists(p):
            p = os.path.join(base, frame_file)  # center fallback (listdatasets_vbm4d.py:38-41)
        frames.append(read_frame(p))
    target = read_frame(os.path.join(root, "noise_free_imgs", video, frame_file))
    return frames, target


class VBM4D:
    """Yields (frames[7], target, path, video) per frame of the 8 videos."""

    def __init__(self, root, task, task_param=(20,), videos=None):
        self.root = root
        self.task = task
        self.task_param = list(task_param)
        self.items = []
        for video in videos or VIDEOS:
            vdir = os.path.join(input_dir(root, task, self.task_param), video)
            if not os.path.isdir(vdir):
                continue
            for f in sorted(x for x in os.listdir(vdir) if x.endswith(".png")):
                self.items.append((video, f))

    def __len__(self):
        return len(self.items)

    def __iter__(self):
        for video, f in self.items:
            frames, target = load_window(self.root, video, f, self.task, self.task_param)
            yield frames, target, f, video


class BayesSR:
    """BayesSR 4-video SR dataset (datasets_benchmark/BayseSR.py:34-41):
    frames under <video>/original; same 7-frame window protocol, the window
    clamped at the video's ends."""

    VIDEOS = ["calendar", "city", "foliage", "walk"]

    def __init__(self, root, videos=None):
        self.root = root
        self.items = []
        for video in videos or self.VIDEOS:
            vdir = os.path.join(root, video, "original")
            if not os.path.isdir(vdir):
                continue
            for f in sorted(os.listdir(vdir)):
                self.items.append((video, f))

    def __len__(self):
        return len(self.items)

    def __iter__(self):
        for video, f in self.items:
            base = os.path.join(self.root, video, "original")
            cur_files = sorted(os.listdir(base))
            idx = cur_files.index(f)
            frames = [read_frame(os.path.join(base, cur_files[min(max(i, 0), len(cur_files) - 1)]))
                      for i in range(idx - 3, idx + 4)]
            target = read_frame(os.path.join(base, f))
            yield frames, target, f, video
