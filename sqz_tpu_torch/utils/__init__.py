"""Utilities of the port: synthetic inputs."""
