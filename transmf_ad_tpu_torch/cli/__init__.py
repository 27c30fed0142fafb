"""Command-line entry points of the port, each run as
`python -m transmf_ad_tpu_torch.cli.<name>`. Importing one parses nothing."""
