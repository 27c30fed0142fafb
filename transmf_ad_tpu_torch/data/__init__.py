"""Data handling of the port: device-side augmentation."""
