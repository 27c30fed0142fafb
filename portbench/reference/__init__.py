"""Plain float32 PyTorch reference of the models, the augmentation and the
train step that the benchmark's cells drive. It imports nothing of the
program under test and nothing of JAX; the configuration file names which
module here is its reference (`"reference"`)."""
