"""Models of the port: ALS, naive Bayes, logistic regression, the
Markov chain and the two-tower retrieval model."""
