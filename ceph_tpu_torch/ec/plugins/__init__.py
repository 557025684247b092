"""The codec plugins of the port: rs, shec, clay."""
