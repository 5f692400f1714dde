"""Host packers and the bucketized table layout."""
