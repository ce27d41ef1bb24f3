"""Data layer of the port: the event model, the in-memory event store,
its columnar decoding, and the storage that training and deploy share."""
