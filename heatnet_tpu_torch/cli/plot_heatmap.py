"""GPS heatmap plotter: harvest heat_stats files → standalone HTML.

Counterpart of ``heatnet_tpu/cli/plot_heatmap.py`` (reference
``data/plot_gm.py:1-41``: recursively collects ``heat_stats_*`` under a
core dir and draws a gmplot Google-Maps heatmap). The renderer is the
offline ``utils.gps_heatmap.write_heatmap_html`` (no network tiles, no
matplotlib); the harvest format and flow are identical.

Usage::

    python -m heatnet_tpu_torch.cli.plot_heatmap --core-dir DUMPS --out heatmaps.html
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Plot GPS heatmap from "
                                            "heat_stats files")
    p.add_argument("--core-dir", required=True,
                   help="directory tree containing heat_stats_* files")
    p.add_argument("--out", default="heatmaps.html")
    p.add_argument("--pattern", default="heat_stats_*")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..utils.gps_heatmap import collect_heat_stats, write_heatmap_html

    lats, lons = collect_heat_stats(args.core_dir, args.pattern)
    if lats:
        print(f"Draw heatmap with {len(lats)} entries")
        write_heatmap_html(lats, lons, args.out)
    else:
        print("no heat_stats entries found")
    return len(lats)


if __name__ == "__main__":
    main()
