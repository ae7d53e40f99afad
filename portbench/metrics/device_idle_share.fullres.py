"""``device_idle_share.serve``'s reader, in the full-resolution serving cell, where the
metric moves ``fullres_frames_per_s``."""

import os

from portbench.harness.manifest import metric_reader

read = metric_reader("device_idle_share.serve", os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
