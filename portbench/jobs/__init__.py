"""One module a kind of job (a traffic file's "kind"): train, eval."""
