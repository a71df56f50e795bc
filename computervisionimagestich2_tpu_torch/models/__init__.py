"""The pipeline stages of the port, up to ``stitcher.Stitcher``."""
