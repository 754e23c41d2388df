"""Plain reference of the video codecs, independent of the program."""
