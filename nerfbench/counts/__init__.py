"""The yardstick's arithmetic: the card's published peaks, the bytes an
entry point must move and the field's multiply-adds a sample."""
