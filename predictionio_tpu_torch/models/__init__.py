"""Models of the port: ALS, naive Bayes, logistic regression and the
Markov chain."""
