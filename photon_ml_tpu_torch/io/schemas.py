"""Photon-compatible Avro wire schemas.

Re-typed from the reference's photon-avro-schemas/src/main/avro/*.avsc so that
models and data produced by this framework interoperate with Photon ML
deployments (same record/field names, same union shapes, same defaults).
"""

NAMESPACE = "com.linkedin.photon.avro.generated"

FEATURE_AVRO = {
    "name": "FeatureAvro",
    "namespace": NAMESPACE,
    "type": "record",
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string"},
        {"name": "value", "type": "double"},
    ],
}

NAME_TERM_VALUE_AVRO = {
    "name": "NameTermValueAvro",
    "namespace": NAMESPACE,
    "type": "record",
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string"},
        {"name": "value", "type": "double"},
    ],
}

TRAINING_EXAMPLE_AVRO = {
    "name": "TrainingExampleAvro",
    "namespace": NAMESPACE,
    "type": "record",
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "label", "type": "double"},
        {"name": "features", "type": {"type": "array", "items": FEATURE_AVRO}},
        {
            "name": "metadataMap",
            "type": ["null", {"type": "map", "values": "string"}],
            "default": None,
        },
        {"name": "weight", "type": ["null", "double"], "default": None},
        {"name": "offset", "type": ["null", "double"], "default": None},
    ],
}

RESPONSE_PREDICTION_AVRO = {
    "name": "SimplifiedResponsePrediction",
    "namespace": NAMESPACE,
    "type": "record",
    "fields": [
        {"name": "response", "type": "double"},
        {"name": "features", "type": {"type": "array", "items": FEATURE_AVRO}},
        {"name": "weight", "type": "double", "default": 1.0},
        {"name": "offset", "type": "double", "default": 0.0},
    ],
}

BAYESIAN_LINEAR_MODEL_AVRO = {
    "name": "BayesianLinearModelAvro",
    "namespace": NAMESPACE,
    "type": "record",
    "fields": [
        {"name": "modelId", "type": "string"},
        {"name": "modelClass", "type": ["null", "string"], "default": None},
        {"name": "means", "type": {"type": "array", "items": NAME_TERM_VALUE_AVRO}},
        {
            "name": "variances",
            "type": ["null", {"type": "array", "items": "NameTermValueAvro"}],
            "default": None,
        },
        {"name": "lossFunction", "type": ["null", "string"], "default": None},
    ],
}

SCORING_RESULT_AVRO = {
    "name": "ScoringResultAvro",
    "namespace": NAMESPACE,
    "type": "record",
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "label", "type": ["null", "double"], "default": None},
        {"name": "modelId", "type": "string"},
        {"name": "predictionScore", "type": "double"},
        {"name": "weight", "type": ["null", "double"], "default": None},
        {
            "name": "metadataMap",
            "type": ["null", {"type": "map", "values": "string"}],
            "default": None,
        },
    ],
}

FEATURE_SUMMARIZATION_RESULT_AVRO = {
    "name": "FeatureSummarizationResultAvro",
    "namespace": NAMESPACE,
    "type": "record",
    "fields": [
        {"name": "featureName", "type": "string"},
        {"name": "featureTerm", "type": "string"},
        {"name": "metrics", "type": {"type": "map", "values": "double"}},
    ],
}

LATENT_FACTOR_AVRO = {
    "name": "LatentFactorAvro",
    "namespace": NAMESPACE,
    "type": "record",
    "fields": [
        {"name": "effectId", "type": "string"},
        {"name": "latentFactor", "type": {"type": "array", "items": "double"}},
    ],
}

# The per-entity random-effect model record used by ModelProcessingUtils:
# (modelId = entity id, means, ...) — same BayesianLinearModelAvro schema.
