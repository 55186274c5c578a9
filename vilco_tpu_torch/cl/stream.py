"""Query-incremental task streams + rehearsal memory.

TPU-native equivalent of the QILSetTask iterators
(MQ/libs/datasets/cl_benchmark.py:18-139, NLQ :18-110, VQ :18-120) and the
rehearsal memory that the reference keeps on the model
(add_samples_to_mem, MQ/libs/modeling/meta_archs.py:972-1055 — random
sampling; the iCaRL herding is dead code there).

Differences by design: the stream is a plain data object (no dataloader
construction inside), and the memory is its own class instead of model
state, so the episode engine composes them with any pipeline.

A copy of vilco_tpu/cl/stream.py: the same code,
its imports pointed at the port (which imports nothing of the JAX
package).
"""

from __future__ import annotations

import pickle
import random
from typing import Dict, List, Optional, Sequence

import numpy as np


def _class_keyed(task: dict) -> Dict[int, List[dict]]:
    """Re-key a task's dict_db by class id (QILSetTask.init_task,
    cl_benchmark.py:36-55): a video appears under every one of its task
    classes."""
    out: Dict[int, List[dict]] = {}
    for class_id in task["label_dict"].values():
        for video in task["dict_db"]:
            if class_id in list(np.asarray(video["labels"]).reshape(-1)):
                out.setdefault(int(class_id), []).append(video)
    return out


def _dedup_by_id(videos: Sequence[dict]) -> List[dict]:
    seen, out = set(), []
    for v in videos:
        if v["id"] not in seen:
            seen.add(v["id"])
            out.append(v)
    return out


class RehearsalMemory:
    """{class_id: [video dicts]} with per-class quota trimming."""

    def __init__(self, seed: int = 0):
        self.data: Dict[int, List[dict]] = {}
        self._rng = random.Random(seed)

    def add_task(self, class_videos: Dict[int, List[dict]], m: int):
        """Merge the finished task's class-keyed videos, shuffle each class,
        trim every class to m (meta_archs.py:1046-1055)."""
        self.data = {**self.data, **class_videos}
        for c, videos in self.data.items():
            self._rng.shuffle(videos)
            self.data[c] = videos[:m]

    @property
    def n_known(self) -> int:
        return len(self.data)

    def videos(self) -> List[dict]:
        out = []
        for vids in self.data.values():
            for v in vids:
                v = dict(v)
                v["is_memory"] = True
                out.append(v)
        return _dedup_by_id(out)

    def save(self, path: str):
        from vilco_tpu_torch.core.checkpoint import save_checkpoint

        save_checkpoint(path, self.data)

    def load(self, path: str):
        from vilco_tpu_torch.core.checkpoint import load_checkpoint

        self.data = load_checkpoint(path)


class TaskStream:
    """Ordered CL sub-tasks from the reference's split-pkl format
    {'train': {task_idx: {'label_dict', 'dict_db'}}, 'val': {...}} (produced
    by scripts/split_mq.py; consumed at MQ/train_cl.py:103)."""

    def __init__(self, train_tasks: Dict[int, dict],
                 val_tasks: Dict[int, dict], shuffle_order: bool = False,
                 seed: int = 0):
        self.task_ids = sorted(train_tasks)
        if shuffle_order:
            random.Random(seed).shuffle(self.task_ids)
        self.train_tasks = train_tasks
        self.val_tasks = val_tasks
        self._train_by_class = {
            j: _class_keyed(train_tasks[j]) for j in self.task_ids
        }

    @classmethod
    def from_pkl(cls, path: str, **kw) -> "TaskStream":
        with open(path, "rb") as f:
            data = pickle.load(f)
        return cls(data["train"], data["val"], **kw)

    @property
    def num_tasks(self) -> int:
        return len(self.task_ids)

    def task_classes(self, j: int) -> List[int]:
        return sorted(self.train_tasks[self.task_ids[j]]["label_dict"].values())

    def classes_upto(self, j: int) -> List[int]:
        out = []
        for i in range(j + 1):
            out.extend(self.task_classes(i))
        return sorted(set(out))

    def train_class_videos(self, j: int) -> Dict[int, List[dict]]:
        return self._train_by_class[self.task_ids[j]]

    def train_videos(self, j: int,
                     memory: Optional[RehearsalMemory] = None) -> List[dict]:
        """Current task's videos merged with rehearsal memory
        (QILSetTask.__next__, cl_benchmark.py:73-97)."""
        videos: List[dict] = []
        if memory is not None:
            videos.extend(memory.videos())
        for vids in self._train_by_class[self.task_ids[j]].values():
            for v in vids:
                v = dict(v)
                v.setdefault("is_memory", False)
                videos.append(v)
        return _dedup_by_id(videos)

    def val_videos_upto(self, j: int) -> List[dict]:
        """Cumulative validation videos for tasks 0..j
        (get_valSet_by_taskNum, cl_benchmark.py:98-114)."""
        videos = []
        for i in range(j + 1):
            videos.extend(self.val_tasks[self.task_ids[i]]["dict_db"])
        return _dedup_by_id(videos)

    def memory_quota(self, memory_size: int, n_classes_seen: int) -> int:
        """m = memory_size // #classes in the (grown) head
        (MQ/train_cl.py:343-349)."""
        return memory_size // max(n_classes_seen, 1)


def merge_tasks(stream: TaskStream) -> TaskStream:
    """Collapse every sub-task into ONE joint task — the reference's non-CL
    upper-bound run (MQ/train.py trains all 110 classes jointly)."""

    def merge(tasks: Dict[int, dict]) -> Dict[int, dict]:
        label_dict: Dict[str, int] = {}
        dict_db: List[dict] = []
        for k in sorted(tasks):
            label_dict.update(tasks[k]["label_dict"])
            dict_db.extend(tasks[k]["dict_db"])
        return {0: {"label_dict": label_dict,
                    "dict_db": _dedup_by_id(dict_db)}}

    return TaskStream(merge(stream.train_tasks), merge(stream.val_tasks))
