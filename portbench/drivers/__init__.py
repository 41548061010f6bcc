"""One module a loop kind, named by a traffic mix's ``driver``."""
