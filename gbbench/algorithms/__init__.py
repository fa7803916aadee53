"""The algorithms a user runs, as DSL recipes: one module a recipe."""
