"""HTTP API layer.

Equivalent of reference src/api/ (SURVEY.md §2.7): generic HTTP server
plumbing, AWS SigV4 authentication (header, presigned query, and streaming
chunk signatures), the S3 API, the Admin API, and shared error rendering.
The HTTP engine is aiohttp — the analogue of the reference's hyper.

The port holds the admission gate (``admission.py``) so far; it imports
no aiohttp.
"""
