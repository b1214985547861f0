"""The benchmark's generic machinery: the manifest, the image generator,
statistics, the trace reader and the import guard."""
