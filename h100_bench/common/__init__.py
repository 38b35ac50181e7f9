"""The yardstick's own pieces: input recipes, peaks, the traffic generator,
the output sink and the trace reader. None of them imports the port."""
