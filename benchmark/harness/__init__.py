"""What every cell shares: finding the cell's files, the card, the load
generator, the S3 client, the nodes, and the reduction of traces and
counters to metrics."""
