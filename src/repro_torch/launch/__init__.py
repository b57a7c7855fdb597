"""Launchers of the port: the continuous-batching server (``serve``)."""
