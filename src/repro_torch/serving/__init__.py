from .scheduler import ContinuousBatcher, Request

__all__ = ["ContinuousBatcher", "Request"]
