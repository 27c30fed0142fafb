"""The least work of the `transmf::` ops outside `counts/kernels.py`'s
`OPS`, one module an op (`counts/kernels.py::count_of`)."""
