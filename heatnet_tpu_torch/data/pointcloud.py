"""PointCloud2 ↔ numpy byte decoding, no ROS.

A copy of ``heatnet_tpu/data/pointcloud.py``. Rebuilds the lidar decoding
slice of the reference capture stack (the reference's
``data/lidar_to_numpy.py:18-70``): a packed point-cloud record buffer (the
sensor_msgs/PointCloud2 wire layout — per-point byte records with typed
fields at byte offsets, possibly padded) decodes to a numpy structured
array, which the capture dump ``np.save``s per burst frame
(``extract_lidar_pcl.py:244-545`` writes ``v64`` .npy files alongside the
camera PNG tree).

The message container here is a plain dataclass with the same field names
as the ROS message, so recorded streams serialize as npz/json without any
ROS dependency.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

# sensor_msgs/PointField datatype enum values (wire-format contract)
INT8, UINT8, INT16, UINT16, INT32, UINT32, FLOAT32, FLOAT64 = range(1, 9)

_PFTYPE_TO_NPTYPE = {
    INT8: np.dtype("int8"), UINT8: np.dtype("uint8"),
    INT16: np.dtype("int16"), UINT16: np.dtype("uint16"),
    INT32: np.dtype("int32"), UINT32: np.dtype("uint32"),
    FLOAT32: np.dtype("float32"), FLOAT64: np.dtype("float64"),
}
_NPTYPE_TO_PFTYPE = {v: k for k, v in _PFTYPE_TO_NPTYPE.items()}
_PFTYPE_SIZES = {k: v.itemsize for k, v in _PFTYPE_TO_NPTYPE.items()}

DUMMY_FIELD_PREFIX = "__"


@dataclass(frozen=True)
class PointField:
    """One typed field of a point record (sensor_msgs/PointField shape)."""

    name: str
    offset: int
    datatype: int  # one of the enum values above
    count: int = 1


@dataclass
class PointCloud(object):
    """PointCloud2-shaped container: packed ``data`` + field descriptors."""

    fields: List[PointField]
    point_step: int
    data: bytes
    height: int = 1
    width: int = 0
    row_step: int = 0
    is_bigendian: bool = False
    is_dense: bool = True


def fields_to_dtype(fields: Sequence[PointField], point_step: int
                    ) -> List[Tuple[str, object]]:
    """PointField list → numpy record dtype list, padding gaps with dummy
    uint8 fields (lidar_to_numpy.py:33-58 semantics)."""
    offset = 0
    np_dtype_list: List[Tuple[str, object]] = []
    for f in fields:
        while offset < f.offset:
            # might be extra padding between fields
            np_dtype_list.append((f"{DUMMY_FIELD_PREFIX}{offset}", np.uint8))
            offset += 1
        dtype = _PFTYPE_TO_NPTYPE[f.datatype]
        if f.count != 1:
            dtype = np.dtype((dtype, f.count))
        np_dtype_list.append((f.name, dtype))
        offset += _PFTYPE_SIZES[f.datatype] * f.count
    # might be extra padding between points
    while offset < point_step:
        np_dtype_list.append((f"{DUMMY_FIELD_PREFIX}{offset}", np.uint8))
        offset += 1
    return np_dtype_list


def cloud_to_array(msg: PointCloud) -> np.ndarray:
    """Decode the packed buffer into a structured array, dummy padding
    fields dropped; (width,) for unorganized clouds, (height, width) for
    organized ones (lidar_to_numpy.py:60-70, ``msg_to_arr``)."""
    dtype_list = fields_to_dtype(msg.fields, msg.point_step)
    arr = np.frombuffer(msg.data, dtype=np.dtype(dtype_list))
    keep = [name for name, _ in dtype_list
            if not name.startswith(DUMMY_FIELD_PREFIX)]
    arr = arr[keep]
    if msg.height == 1:
        return np.reshape(arr, (msg.width,))
    return np.reshape(arr, (msg.height, msg.width))


# keep the reference entry-point name alive for parity greps
msg_to_arr = cloud_to_array


def array_to_cloud(arr: np.ndarray) -> PointCloud:
    """Inverse of :func:`cloud_to_array` for recording synthetic streams."""
    if arr.dtype.names is None:
        raise ValueError("array_to_cloud needs a structured array")
    fields = []
    for name in arr.dtype.names:
        sub_dtype, offset = arr.dtype.fields[name][:2]
        base = sub_dtype.base if sub_dtype.subdtype else sub_dtype
        count = int(np.prod(sub_dtype.shape)) if sub_dtype.shape else 1
        fields.append(PointField(name=name, offset=offset,
                                 datatype=_NPTYPE_TO_PFTYPE[base],
                                 count=count))
    if arr.ndim == 1:
        height, width = 1, arr.shape[0]
    else:
        height, width = arr.shape
    return PointCloud(fields=fields, point_step=arr.dtype.itemsize,
                      data=arr.tobytes(), height=height, width=width,
                      row_step=arr.dtype.itemsize * width)


def xyz_from_cloud(msg: PointCloud) -> np.ndarray:
    """Convenience: (N, 3) float32 xyz from any cloud with x/y/z fields."""
    arr = cloud_to_array(msg).reshape(-1)
    return np.stack([arr["x"], arr["y"], arr["z"]],
                    axis=-1).astype(np.float32)
