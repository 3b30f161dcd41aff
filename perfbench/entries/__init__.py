"""The port's public entries, one module each, as a time loop drives them.

An ``Entry(stencil, config, traffic, inputs, devices)`` holds the program's
fields, made from the benchmark's inputs. ``call(info=None)`` is one timed
call (``info``: the port's ``exec_info``, given only to checked calls);
``steps_per_call`` the model steps one call makes; ``view()`` the carried
roles' content as the user reads it (global arrays); ``tensors()`` every
tensor holding the program's state (restored after the warm-up);
``strategies(info)`` what served a checked call (the port's own words).
"""
