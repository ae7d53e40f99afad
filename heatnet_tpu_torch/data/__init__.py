"""Frame packs (inference and train), batches, augmentation on the device."""
