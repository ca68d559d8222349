"""One runner per traffic kind (the ``kind`` key of a traffic file)."""
