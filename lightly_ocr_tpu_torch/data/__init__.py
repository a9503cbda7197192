"""Training data of the port: LOR1 records, the loader, the generators."""
