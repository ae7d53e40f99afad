"""Offline transform buffer: lookup / interpolation / averaging, no ROS.

A copy of ``heatnet_tpu/data/tf_store.py``. Rebuilds the semantics of the
reference's vendored ``BagTfTransformer`` (the reference's
``data/tf_bag.py:13-517``) on a plain stamped-transform store instead of a
rosbag + tf.Transformer:

- ``lookup_transform(orig, dest, t)`` — tf-style lookup: evaluates every
  edge of the frame chain at the latest common time ≤ ``t + lookahead``
  (tf_bag.py:272-289 populates a 10 s buffer with 0.1 s lookahead and
  queries ``getLatestCommonTime``), interpolating between bracketing
  messages (translation lerp + quaternion slerp, tf BufferCore semantics),
  then composes along the chain. Returns ``(translation, (x,y,z,w))`` —
  the pose of ``dest`` expressed in ``orig`` (the reference looks up
  ``('odom_combined', 'base_link')`` to get the vehicle pose in odom,
  bag_parser.py:434).
- chain discovery (``get_chain``/``get_chain_tuples``/ancestors,
  tf_bag.py:329-364), ``wait_for_transform`` (:243-272),
  ``get_transform_update_times`` (:202-241), naive-normalized-mean
  ``average_transforms`` (:365-381, reproduced exactly including the
  "horrible but fine for small rotations" quaternion mean),
  ``average_transform_over_time`` (:383-408),
  ``replicate_transform_over_time`` (:410-447, a-posteriori calibration
  injection) and ``process_transform`` (:449-467).

Storage is numpy per directed edge (sorted stamp arrays → O(log n)
bisect lookups), loaded from anything that yields stamped transforms —
including the JSONL stream the capture pipeline records
(``cli/dump_capture.py``) in place of /tf rosbags.

Times are float seconds in the public API (ns integers internally, so
1 ns resolution survives round-tripping).
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from .transforms3d import (matrix_to_pair, pair_to_matrix, quaternion_slerp,
                           rigid_inverse)

Pair = Tuple[Tuple[float, float, float], Tuple[float, float, float, float]]

IDENTITY: Pair = ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0))


def _ns(t: float) -> int:
    return int(round(float(t) * 1e9))


@dataclass(frozen=True)
class StampedTransform:
    """One /tf message: pose of ``child`` in ``parent`` at time ``stamp``."""

    parent: str
    child: str
    stamp: float  # seconds
    translation: Tuple[float, float, float]
    rotation: Tuple[float, float, float, float]  # (x, y, z, w)


class TransformLookupError(RuntimeError):
    """Raised when a chain cannot be evaluated (tf_bag.py:283-286)."""


class _Edge:
    """All messages of one directed (parent, child) edge, time-sorted."""

    def __init__(self):
        self.times: List[int] = []  # ns, sorted
        self.trans: List[np.ndarray] = []
        self.quats: List[np.ndarray] = []

    def insert(self, t_ns: int, trans, quat) -> None:
        i = bisect.bisect_right(self.times, t_ns)
        self.times.insert(i, t_ns)
        self.trans.insert(i, np.asarray(trans, np.float64))
        self.quats.insert(i, np.asarray(quat, np.float64))

    def latest_at_or_before(self, t_ns: int) -> Optional[int]:
        i = bisect.bisect_right(self.times, t_ns)
        return self.times[i - 1] if i else None

    def sample(self, t_ns: int) -> Tuple[np.ndarray, np.ndarray]:
        """Interpolated (translation, quaternion) at ``t_ns``.

        Between two messages: lerp + slerp. At/past the ends: clamps to the
        boundary message (callers bound ``t_ns`` by latest-common-time, so
        forward extrapolation never goes past data; a single-message edge
        acts as a static transform).
        """
        times = self.times
        i = bisect.bisect_left(times, t_ns)
        if i < len(times) and times[i] == t_ns:
            return self.trans[i], self.quats[i]
        if i == 0:
            return self.trans[0], self.quats[0]
        if i == len(times):
            return self.trans[-1], self.quats[-1]
        t0, t1 = times[i - 1], times[i]
        f = (t_ns - t0) / (t1 - t0)
        tr = (1.0 - f) * self.trans[i - 1] + f * self.trans[i]
        q = quaternion_slerp(self.quats[i - 1], self.quats[i], f)
        return tr, q


class TransformStore:
    """The offline TF buffer (BagTfTransformer equivalent)."""

    def __init__(self, transforms: Iterable[StampedTransform] = (),
                 buffer_length: float = 10.0, lookahead: float = 0.1):
        self.buffer_length = float(buffer_length)
        self.lookahead = float(lookahead)
        self._edges: Dict[Tuple[str, str], _Edge] = {}
        self._all_times: List[int] = []
        self._frames: Set[str] = set()
        for m in transforms:
            self.set_transform(m.parent, m.child, m.stamp,
                               m.translation, m.rotation)

    # -- population --------------------------------------------------------

    def set_transform(self, parent: str, child: str, stamp: float,
                      translation, rotation) -> None:
        edge = self._edges.setdefault((parent, child), _Edge())
        t_ns = _ns(stamp)
        edge.insert(t_ns, translation, rotation)
        bisect.insort(self._all_times, t_ns)
        self._frames.add(parent)
        self._frames.add(child)

    @classmethod
    def from_jsonl(cls, path: str, **kw) -> "TransformStore":
        """Load from the capture pipeline's tf.jsonl: one object per line
        with keys t/parent/child/translation/rotation."""
        store = cls(**kw)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                store.set_transform(rec["parent"], rec["child"], rec["t"],
                                    rec["translation"], rec["rotation"])
        return store

    def to_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for (parent, child), edge in sorted(self._edges.items()):
                for t_ns, tr, q in zip(edge.times, edge.trans, edge.quats):
                    f.write(json.dumps({
                        "t": t_ns / 1e9, "parent": parent, "child": child,
                        "translation": list(map(float, tr)),
                        "rotation": list(map(float, q))}) + "\n")

    # -- introspection (tf_bag.py:122-177) ---------------------------------

    def get_frame_strings(self) -> Set[str]:
        return set(self._frames)

    def get_transform_frame_tuples(self) -> Set[Tuple[str, str]]:
        return set(self._edges)

    def get_start_time(self) -> float:
        if not self._all_times:
            raise ValueError("empty transform store")
        return self._all_times[0] / 1e9

    def get_end_time(self) -> float:
        if not self._all_times:
            raise ValueError("empty transform store")
        return self._all_times[-1] / 1e9

    def get_time_at_percent(self, percent: float) -> float:
        start, end = self.get_start_time(), self.get_end_time()
        return start + (end - start) * (percent / 100.0)

    def get_messages_in_time_range(self, min_time: Optional[float] = None,
                                   max_time: Optional[float] = None
                                   ) -> List[StampedTransform]:
        """All messages with min_time < stamp < max_time (exclusive, as
        tf_bag.py:51)."""
        lo = -float("inf") if min_time is None else _ns(min_time)
        hi = float("inf") if max_time is None else _ns(max_time)
        if hi < lo:
            raise ValueError(
                "the minimum time should be lesser than the maximum time!")
        out = []
        for (parent, child), edge in self._edges.items():
            for t_ns, tr, q in zip(edge.times, edge.trans, edge.quats):
                if lo < t_ns < hi:
                    out.append(StampedTransform(parent, child, t_ns / 1e9,
                                                tuple(tr), tuple(q)))
        out.sort(key=lambda m: _ns(m.stamp))
        return out

    # -- chain discovery (tf_bag.py:305-364) -------------------------------

    def get_frame_ancestors(self, frame: str,
                            early_stop_frame: Optional[str] = None
                            ) -> List[str]:
        chain = [frame]
        tuples = self.get_transform_frame_tuples()
        parents = {c: p for p, c in tuples}
        while chain[-1] in parents and chain[-1] != early_stop_frame:
            parent = parents[chain[-1]]
            if parent in chain:  # cycle guard (malformed data)
                break
            chain.append(parent)
        return list(reversed(chain))

    def get_chain(self, orig_frame: str, dest_frame: str) -> List[str]:
        """Frame path between two frames through their common ancestor."""
        orig_anc = self.get_frame_ancestors(orig_frame,
                                            early_stop_frame=dest_frame)
        if orig_anc[0] == dest_frame:
            return orig_anc
        dest_anc = self.get_frame_ancestors(dest_frame,
                                            early_stop_frame=orig_frame)
        if dest_anc[0] == orig_frame:
            return dest_anc
        # strip the shared root prefix, then join orig-up + dest-down
        common = 0
        while (common < len(orig_anc) and common < len(dest_anc)
               and orig_anc[common] == dest_anc[common]):
            common += 1
        if common == 0:
            raise TransformLookupError(
                f"frames {orig_frame} and {dest_frame} are not connected")
        pivot = orig_anc[common - 1]
        # [orig ... child-of-pivot] + pivot + [child-of-pivot ... dest]
        return (list(reversed(orig_anc[common:])) + [pivot]
                + dest_anc[common:])

    def get_chain_tuples(self, orig_frame: str, dest_frame: str
                         ) -> List[Tuple[str, str]]:
        chain = self.get_chain(orig_frame, dest_frame)
        return list(zip(chain[:-1], chain[1:]))

    def _oriented_chain_tuples(self, orig_frame: str, dest_frame: str
                               ) -> List[Tuple[str, str]]:
        """Chain tuples guaranteed to run orig → dest (the reference's
        getChain may return either direction — it only uses the chain for
        membership, while composition here needs orientation)."""
        chain = self.get_chain(orig_frame, dest_frame)
        if chain[0] != orig_frame:
            chain = list(reversed(chain))
        return list(zip(chain[:-1], chain[1:]))

    # -- lookup (tf_bag.py:272-289) ----------------------------------------

    def _directed_edge(self, a: str, b: str) -> Tuple[_Edge, bool]:
        """Edge between a and b, plus whether it is stored reversed."""
        if (a, b) in self._edges:
            return self._edges[(a, b)], False
        if (b, a) in self._edges:
            return self._edges[(b, a)], True
        raise TransformLookupError(f"no direct transform between {a} and {b}")

    def latest_common_time(self, orig_frame: str, dest_frame: str,
                           time: Optional[float] = None) -> float:
        """Latest time ≤ time+lookahead at which every chain edge has data."""
        bound = (float("inf") if time is None
                 else _ns(time + self.lookahead))
        common: Optional[int] = None
        for a, b in self._oriented_chain_tuples(orig_frame, dest_frame):
            edge, _ = self._directed_edge(a, b)
            latest = edge.latest_at_or_before(min(bound, edge.times[-1]))
            if latest is None:
                raise TransformLookupError(
                    f"no data for {a}->{b} at or before the requested time")
            common = latest if common is None else min(common, latest)
        assert common is not None
        return common / 1e9

    def wait_for_transform(self, orig_frame: str, dest_frame: str,
                           start_time: Optional[float] = None) -> float:
        """First time the whole chain is available (tf_bag.py:243-272)."""
        if orig_frame == dest_frame:
            return self._all_times[0] / 1e9
        lo = None if start_time is None else _ns(start_time)
        ret = 0
        for a, b in self.get_chain_tuples(orig_frame, dest_frame):
            edge, _ = self._directed_edge(a, b)
            times = edge.times
            i = 0 if lo is None else bisect.bisect_right(times, lo)
            if i >= len(times):
                raise ValueError(
                    f"Transform not found between {orig_frame} and "
                    f"{dest_frame}")
            ret = max(ret, times[i])
        return ret / 1e9

    def lookup_transform(self, orig_frame: str, dest_frame: str,
                         time: float) -> Pair:
        """tf-style lookup: pose of ``dest_frame`` in ``orig_frame``.

        Evaluates every edge at the chain's latest common time ≤
        ``time + lookahead`` with lerp/slerp interpolation, then composes.
        Raises TransformLookupError when the chain has no data in the
        ``buffer_length`` window before ``time`` (the reference's
        "Could not find the transformation ... in the 10 seconds before"
        RuntimeError, tf_bag.py:283-286).
        """
        if orig_frame == dest_frame:
            return IDENTITY
        common = self.latest_common_time(orig_frame, dest_frame, time)
        if common < time - self.buffer_length:
            raise TransformLookupError(
                f"Could not find the transformation {orig_frame} -> "
                f"{dest_frame} in the {self.buffer_length:g} seconds "
                f"before time {time}")
        t_ns = _ns(common)
        T = np.eye(4)
        for a, b in self._oriented_chain_tuples(orig_frame, dest_frame):
            edge, reversed_ = self._directed_edge(a, b)
            tr, q = edge.sample(t_ns)
            T_ab = pair_to_matrix(tr, q)
            if reversed_:
                T_ab = rigid_inverse(T_ab)
            T = T @ T_ab
        tr, q = matrix_to_pair(T)
        return tuple(map(float, tr)), tuple(map(float, q))

    # -- update times (tf_bag.py:202-241) ----------------------------------

    def get_transform_update_times(
            self, orig_frame: str, dest_frame: str,
            trigger_orig_frame: Optional[str] = None,
            trigger_dest_frame: Optional[str] = None,
            start_time: Optional[float] = None,
            end_time: Optional[float] = None) -> List[float]:
        """Times at which the (trigger) transform updates, starting when the
        full chain is complete."""
        triggers_provided = (trigger_orig_frame is not None
                             or trigger_dest_frame is not None)
        t_orig = trigger_orig_frame or orig_frame
        t_dest = trigger_dest_frame or dest_frame
        if (t_dest, t_orig) in self._edges and (t_orig, t_dest) not in self._edges:
            t_orig, t_dest = t_dest, t_orig
        edge = self._edges.get((t_orig, t_dest))
        if edge is None:
            if triggers_provided:
                raise RuntimeError(
                    f"the provided trigger frames ({t_orig}->{t_dest}) "
                    "must be directly connected!")
            raise RuntimeError(
                f"the two frames ({t_orig}->{t_dest}) are not directly "
                'connected! you must provide directly connected '
                '"trigger frames"')
        lo = -float("inf") if start_time is None else _ns(start_time)
        hi = float("inf") if end_time is None else _ns(end_time)
        first = _ns(self.wait_for_transform(orig_frame, dest_frame,
                                            start_time=start_time))
        return [t / 1e9 for t in edge.times if lo < t < hi and t > first]

    def lookup_transform_when_updates(
            self, orig_frame: str, dest_frame: str,
            trigger_orig_frame: Optional[str] = None,
            trigger_dest_frame: Optional[str] = None,
            start_time: Optional[float] = None,
            end_time: Optional[float] = None):
        times = self.get_transform_update_times(
            orig_frame, dest_frame, trigger_orig_frame, trigger_dest_frame,
            start_time, end_time)
        return [(t, self.lookup_transform(orig_frame, dest_frame, t))
                for t in times]

    def process_transform(self, callback, orig_frame: str, dest_frame: str,
                          trigger_orig_frame: Optional[str] = None,
                          trigger_dest_frame: Optional[str] = None,
                          start_time: Optional[float] = None,
                          end_time: Optional[float] = None):
        for t, tr in self.lookup_transform_when_updates(
                orig_frame, dest_frame, trigger_orig_frame,
                trigger_dest_frame, start_time, end_time):
            yield callback(t, tr)

    # -- averaging / replication (tf_bag.py:365-447) -----------------------

    @staticmethod
    def average_transforms(transforms: Sequence[Pair]) -> Pair:
        """Mean transform; quaternion mean is the normalized component mean
        (reproduces tf_bag.py:379 — valid only for nearby rotations, which
        is its calibration-averaging use case)."""
        transforms = list(transforms)
        if not transforms:
            raise RuntimeError(
                "requested average of an empty vector of transforms")
        translations = np.array([t[0] for t in transforms], np.float64)
        quaternions = np.array([t[1] for t in transforms], np.float64)
        mean_t = translations.mean(axis=0)
        mean_q = quaternions.mean(axis=0)
        mean_q = mean_q / np.linalg.norm(mean_q)
        return tuple(map(float, mean_t)), tuple(map(float, mean_q))

    def average_transform_over_time(
            self, orig_frame: str, dest_frame: str,
            start_time: float, end_time: float,
            trigger_orig_frame: Optional[str] = None,
            trigger_dest_frame: Optional[str] = None) -> Pair:
        if orig_frame == dest_frame:
            return IDENTITY
        times = self.get_transform_update_times(
            orig_frame, dest_frame, trigger_orig_frame, trigger_dest_frame,
            start_time, end_time)
        return self.average_transforms(
            [self.lookup_transform(orig_frame, dest_frame, t)
             for t in times])

    def replicate_transform_over_time(
            self, transf: Pair, orig_frame: str, dest_frame: str,
            frequency: float, start_time: Optional[float] = None,
            end_time: Optional[float] = None) -> None:
        """Inject a fixed transform at a given rate — a-posteriori
        calibration (tf_bag.py:410-447)."""
        if start_time is None:
            start_time = self.get_start_time()
        if end_time is None:
            end_time = self.get_end_time()
        transl, quat = transf
        step_ns = int(round(1e9 / frequency))
        for t_ns in range(_ns(start_time), _ns(end_time), step_ns):
            self.set_transform(orig_frame, dest_frame, t_ns / 1e9,
                               transl, quat)

    def get_average_update_frequency(
            self, orig_frame: str, dest_frame: str,
            start_time: Optional[float] = None,
            end_time: Optional[float] = None) -> float:
        """Mean inter-message interval (seconds) of a direct edge
        (tf_bag.py:183-199 — which, despite the name, returns the average
        time delta, not a frequency; semantics preserved)."""
        edge, _ = self._directed_edge(orig_frame, dest_frame)
        lo = -float("inf") if start_time is None else _ns(start_time)
        hi = float("inf") if end_time is None else _ns(end_time)
        times = np.array([t for t in edge.times if lo < t < hi], np.int64)
        return float(np.diff(times).mean() / 1e9)
