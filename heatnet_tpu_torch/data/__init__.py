"""Frame packs (heatnet-pack-v1)."""
