"""``serve_mfu``'s reader, in the full-resolution serving cell, where the
share moves ``fullres_frames_per_s``."""

import os

from portbench.harness.manifest import metric_reader

read = metric_reader("serve_mfu", os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
