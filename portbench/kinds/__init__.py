"""One module per traffic kind; a mix file names its kind."""
