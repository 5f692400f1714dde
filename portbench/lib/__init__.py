"""The harness's parts: the wire codec, key draws, the generator, the
deployments, the reference, the /metrics and trace readers."""
