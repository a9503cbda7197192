"""CRNN training of the port: the train and eval steps and the trainer."""
