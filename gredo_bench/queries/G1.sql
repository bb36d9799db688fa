SELECT Customer.id, t.tid FROM Customer MATCH (p:Persons)-[e0:Interested_in]->(t:Tags) ON Interested_in WHERE t.content = 'food' AND Customer.person_id = p.pid
