"""The users' stencil programs, in GTScript, one module a program."""
