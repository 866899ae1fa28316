"""Plain references the benchmark judges the program by: plain torch,
float32 with TF32 off, importing nothing of the program."""
