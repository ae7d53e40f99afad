"""Frame packs, PNG files, eval loaders, batches, augmentation on the device."""
