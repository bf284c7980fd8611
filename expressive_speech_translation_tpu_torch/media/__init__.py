"""Media I/O: WAV read and write in numpy."""
