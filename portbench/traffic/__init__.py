"""The generators of the cells' inputs, made from the seed. Import
nothing of the program."""
