"""S3-compatible API (ref src/api/s3/)."""
