"""Version string, embedded in log.json (`setting.version`)."""

VERSION = "eigenkernel-tpu-torch 0.1.0"
