"""Measurement tools of the port: device-side probes and the pipeline
profile (`python -m betapose_tpu_torch.tools.<name> --help`)."""
