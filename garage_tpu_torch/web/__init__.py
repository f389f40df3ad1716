"""Static website server (ref src/web/, SURVEY.md §2.8)."""

from .web_server import WebServer

__all__ = ["WebServer"]
